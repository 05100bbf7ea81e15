"""Serving launcher of the port: timed traffic through `Engine`, optionally
compressed weights, on the card unless ``--device cpu`` asks for the
plain versions::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --compress aida --density 0.25 --requests 16 \\
      --workload heterogeneous --chunk 8 --policy sjf

Without ``--full-size`` the architecture is cut to its reduced size for a
quick functional serve; weights are random from the engine's seed.
``--disagg`` serves through a prefill role and a decode role on the same
device, with KV page migration between their pools (``--prefill-slots``,
``--decode-slots``); ``--fault-plan PRESET:SEED``, ``--deadline-ticks``
and ``--max-retries`` turn on the resilience layer, which reports what it
did (and which requests failed, structurally) under ``resil`` in
``--json``.  The flags and the ``[serve]`` lines are the JAX package's
launcher's, less the mesh ones (``--mesh``, ``--prefill-devices``,
``--decode-devices``), which wait for the shard layer's port.  Without a
visible card and without ``--device cpu`` it stops with an error; it never
falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

#: the launcher serves at this context length, as the JAX package's does
MAX_LEN = 128


def _parser() -> argparse.ArgumentParser:
    from repro_torch.resil import PRESETS as RESIL_PRESETS
    from repro_torch.sched.workload import PRESETS
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card; "
                         "'cpu' runs every kernel's plain version)")
    ap.add_argument("--compress", default=None,
                    choices=[None, "int8", "codebook4", "acsr", "aida"])
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--kv-cache", default=None,
                    choices=[None, "auto", "full", "paged"],
                    help="None/auto = the page-pool KV cache wherever the "
                         "arch has attention; full = the dense per-slot "
                         "cache (chunk 1)")
    ap.add_argument("--workload", default="uniform", choices=list(PRESETS),
                    help="request-mix preset (sched.workload): prompt "
                         "lengths, max_new, arrival process")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="override the preset's prompt-length range with "
                         "a fixed length")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload RNG seed (schedules replay exactly)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="prefill tokens per model call (1 = token by "
                         "token; attention-only archs)")
    ap.add_argument("--policy", default="fifo", choices=["fifo", "sjf"],
                    help="admission order: FIFO or shortest-prompt-first")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share full prompt-prefix pages across requests")
    ap.add_argument("--kv-pool-pages", type=int, default=None,
                    help="page-pool size (small pools exercise admission "
                         "control and preemption instead of crashing)")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serving: a prefill role and a "
                         "decode role with KV page migration "
                         "(repro_torch.disagg), on the same device")
    ap.add_argument("--prefill-slots", type=int, default=4,
                    help="prefill-role batch slots (with --disagg)")
    ap.add_argument("--decode-slots", type=int, default=4,
                    help="decode-role batch slots (with --disagg)")
    ap.add_argument("--fault-plan", default=None, metavar="PRESET:SEED",
                    help="inject deterministic faults (repro_torch.resil): "
                         "one of " + ", ".join(
                             sorted(k for k in RESIL_PRESETS if k != "none"))
                         + "; e.g. drop-handoff:3")
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="per-request completion budget in scheduler "
                         "ticks; missed deadlines become structured "
                         "RequestFailed results, not hangs")
    ap.add_argument("--max-retries", type=int, default=None,
                    help="recompute re-admissions allowed per request "
                         "before it fails with 'retries_exhausted' "
                         "(default 2 when the resil layer is on)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON "
                         "timeline of every serving seam (repro_torch.obs); "
                         "tick-clock timestamps, so two same-seed runs "
                         "give byte-identical traces")
    ap.add_argument("--trace-ring", type=int, default=None, metavar="N",
                    help="keep the last N events in a flight-recorder "
                         "ring, dumped to disk on OutOfPages")
    ap.add_argument("--profile-dir", default=None, metavar="PATH",
                    help="wrap the serve in a torch.profiler capture "
                         "(Chrome trace of host and device activity)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the run's metrics, resil and role summary "
                         "as machine-readable JSON (with provenance)")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write an obs.analyze TraceReport of this serve: "
                         "per-request critical paths, queueing split, "
                         "utilisation, page pressure; tick-denominated, "
                         "so two same-seed runs give byte-identical "
                         "reports")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="evaluate the run against an SLO, e.g. "
                         "'ttft_p99=40,tpot_p99=4,goodput=0.95' "
                         "(scheduler-tick units); the verdict is printed "
                         "and embedded in --report")
    return ap


def _resil(ap, args) -> Optional[dict]:
    """The resilience layer's config from --fault-plan / --deadline-ticks
    / --max-retries (the watchdog audits every 8 ticks), or None when none
    is given."""
    from repro_torch.resil import FaultPlan
    if args.fault_plan is None and args.deadline_ticks is None \
            and args.max_retries is None:
        return None
    if args.deadline_ticks is not None and args.deadline_ticks < 1:
        ap.error("--deadline-ticks must be >= 1")
    if args.max_retries is not None and args.max_retries < 0:
        ap.error("--max-retries must be >= 0")
    resil = {"watchdog_every": 8}
    if args.fault_plan is not None:
        try:
            resil["fault_plan"] = FaultPlan.parse(args.fault_plan)
        except ValueError as e:
            ap.error(str(e))
    if args.deadline_ticks is not None:
        resil["deadline_ticks"] = args.deadline_ticks
    if args.max_retries is not None:
        resil["max_retries"] = args.max_retries
    return resil


def _tracer(ap, args, slo):
    """A Tracer when any of --trace / --report / --slo / --trace-ring is
    given (capture stays off for a pure flight-recorder ring), else None."""
    from repro_torch.obs import FlightRecorder, Tracer
    need_capture = (args.trace is not None or args.report is not None
                    or slo is not None)
    if not need_capture and args.trace_ring is None:
        return None
    recorder = None
    if args.trace_ring is not None:
        if args.trace_ring < 1:
            ap.error("--trace-ring must be >= 1")
        # dump destination, most explicit wins: --profile-dir (the run's
        # artifact dir) > the --trace file's dir > the working directory
        if args.profile_dir is not None:
            out_dir = args.profile_dir
            os.makedirs(out_dir, exist_ok=True)
        elif args.trace is not None:
            out_dir = os.path.dirname(os.path.abspath(args.trace))
        else:
            out_dir = "."
        recorder = FlightRecorder(capacity=args.trace_ring, out_dir=out_dir)
    return Tracer(capture=need_capture, recorder=recorder)


def _report(tracer, slo, path: Optional[str]) -> None:
    """Print the trace analysis (critical path, SLO verdict) and write it
    to ``path`` when given."""
    from repro_torch.obs import analyze
    rep = analyze(tracer, slo=slo)
    shares = ", ".join(
        f"{ph} {rec['share']:.0%}" for ph, rec
        in rep.critical_path.items() if rec["ticks"])
    print(f"[serve] critical path ({rep.ticks['span']} ticks): "
          + (shares or "idle"))
    if not rep.segments_consistent():
        print("[serve] WARNING: per-request segments do not sum to "
              "request spans — trace is incomplete or corrupt")
    if rep.slo is not None:
        verdict = "PASS" if rep.slo["pass"] else "FAIL"
        print(f"[serve] slo {verdict}: " + ", ".join(
            f"{name} {rec['value']} vs {rec['bound']} "
            f"({'ok' if rec['pass'] else 'VIOLATED'})"
            for name, rec in sorted(rep.slo["metrics"].items())))
        for name, rec in sorted(rep.slo["metrics"].items()):
            if rec["violators"]:
                print(f"[serve]   {name} violators: rids "
                      f"{rec['violators']}")
    if path is not None:
        rep.write(path)
        print(f"[serve] report: trace analysis -> {path}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)

    from repro_torch.api import CompressionSpec, Engine
    from repro_torch.core.device import resolve_device
    from repro_torch.configs import get, reduced
    from repro_torch.obs import SLOSpec, profile_trace, provenance
    from repro_torch.sched import (SchedConfig, WorkloadSpec, generate,
                                   summarize)

    slo = None
    if args.slo is not None:
        try:
            slo = SLOSpec.parse(args.slo)
        except ValueError as e:
            ap.error(str(e))
    resil = _resil(ap, args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(2, f"[serve] {e}\n")

    cfg = get(args.arch) if args.full_size else reduced(get(args.arch))
    if not cfg.has_decode:
        ap.exit(2, f"[serve] {cfg.name} is an encoder: it has no decode "
                "step to serve\n")
    print(f"[serve] {cfg.name}: ~{cfg.params_count()/1e6:.1f}M params "
          f"on {device}")
    eng = Engine(cfg, device=device)
    backend = f"torch-{device.type}"
    if args.compress:
        eng.compress(CompressionSpec(mode=args.compress,
                                     density=args.density))
        print(f"[serve] {args.compress}: {eng.stats['n_compressed']} "
              f"projections, {eng.stats['ratio']:.1f}x weight memory "
              f"(backend: {backend})")

    overrides = dict(n_requests=args.requests, max_new=(1, args.max_new),
                     vocab=cfg.vocab, seed=args.seed)
    if args.prompt_len is not None:
        overrides["prompt_len"] = (args.prompt_len, args.prompt_len)
    arrivals = generate(WorkloadSpec.preset(args.workload, **overrides))

    disagg = None
    if args.disagg:
        disagg = {"prefill_slots": args.prefill_slots,
                  "decode_slots": args.decode_slots}
    tracer = _tracer(ap, args, slo)
    sess = eng.session(batch_slots=args.slots, max_len=MAX_LEN,
                       kv_cache=args.kv_cache,
                       kv_pool_pages=args.kv_pool_pages,
                       scheduler=SchedConfig(
                           policy=args.policy, chunk=args.chunk,
                           prefix_cache=args.prefix_cache),
                       disagg=disagg, resil=resil, obs=tracer)
    pre = sess.pre if args.disagg else sess
    paged = pre.alloc is not None
    print(f"[serve] workload={args.workload} seed={args.seed} "
          f"kv={'paged' if paged else 'full'} chunk={pre.chunk} "
          f"policy={args.policy}" + (" disagg" if args.disagg else ""))
    if resil is not None:
        print(f"[serve] resil: fault_plan={args.fault_plan or 'none'} "
              f"deadline_ticks={args.deadline_ticks} "
              f"max_retries={resil.get('max_retries', 2)}")
    t0 = time.perf_counter()
    # injected faults and deadlines make partial completion an expected
    # outcome: report it instead of raising
    with profile_trace(args.profile_dir):
        sess.run_workload(
            arrivals, on_incomplete="warn" if resil is not None else "raise")
    dt = time.perf_counter() - t0
    rsumm = sess.resil_summary()
    if args.disagg:
        m = summarize(sess.records, dt,
                      sess.pre.stats["steps"] + sess.dec.stats["steps"],
                      roles=sess.role_stats(), resil=rsumm)
    else:
        m = summarize(sess.records, dt, sess.stats["steps"], resil=rsumm)
    print(f"[serve] {m['completed']}/{m['requests']} requests, "
          f"{m['tokens']} tokens, {m['tok_per_s']:.1f} tok/s, "
          f"goodput {m['goodput_req_per_s']:.2f} req/s "
          f"({m['steps']} model calls)")
    if rsumm is not None:
        line = (f"[serve] resil: shed {rsumm['shed']}, retries "
                f"{rsumm['retries']}, deadline misses "
                f"{rsumm['deadline_miss']}, failed {len(sess.failed)}")
        if rsumm.get("faults"):
            line += ", injected " + ", ".join(
                f"{k}={v}" for k, v in sorted(rsumm["faults"].items()))
        print(line)
        for f in sess.failed:
            print(f"[serve]   {f!r}")
    if m["ttft_s"]:
        print(f"[serve] TTFT p50 {m['ttft_s']['p50']*1e3:.0f} ms / "
              f"p99 {m['ttft_s']['p99']*1e3:.0f} ms; "
              f"preemptions {m['preemptions']}, "
              f"prefix pages reused {m['prefix_pages_reused']}")
    pages = None
    if args.disagg:
        roles, hand = m["roles"], m.get("handoff")
        line = (f"[serve] roles: prefill {roles['prefill']['steps']} "
                f"steps ({roles['prefill']['utilization'] or 0:.0%} busy),"
                f" decode {roles['decode']['steps']} steps "
                f"({roles['decode']['utilization'] or 0:.0%} busy)")
        if hand:
            line += (f"; handoffs {hand['count']}, mean latency "
                     f"{hand['latency_s']['mean']*1e3:.1f} ms, "
                     f"{hand['migrated_bytes']} bytes migrated")
        print(line)
        # the prefill role pins prompt pages into its prefix cache, which
        # outlive the requests by design, as below
        cached = sess.pre.prefix.releasable(sess.pre.alloc) \
            if sess.pre.prefix is not None else 0
        pages = {"prefill_peak": sess.pre.stats["pages_peak"],
                 "decode_peak": sess.dec.stats["pages_peak"],
                 "cached": cached,
                 "leaked": sess.pre.alloc.in_use + sess.dec.alloc.in_use
                 - cached}
        print(f"[serve] pages: prefill peak {pages['prefill_peak']} / "
              f"decode peak {pages['decode_peak']}, cached {cached}, "
              f"leaked {pages['leaked']}")
    elif paged:
        # the prefix cache's own pins outlive the requests by design: a
        # page owned by anything else once every request is done leaked
        cached = sess.prefix.releasable(sess.alloc) \
            if sess.prefix is not None else 0
        pages = {"peak": sess.stats["pages_peak"],
                 "allocs": sess.stats["page_allocs"],
                 "cached": cached, "leaked": sess.alloc.in_use - cached}
        print(f"[serve] pages: peak {pages['peak']}, allocs "
              f"{pages['allocs']}, reclaimed(SWA) "
              f"{sess.stats['pages_reclaimed_swa']}, cached {cached}, "
              f"leaked {pages['leaked']}")
    if args.trace is not None:
        tracer.export(args.trace)
        wall = tracer.wall.summary()
        line = f"[serve] trace: {len(tracer.events)} events -> {args.trace}"
        if wall:
            line += "; wall " + ", ".join(
                f"{k} {v['seconds']:.2f}s/{v['calls']}" for k, v
                in wall.items())
        print(line)
    if args.report is not None or slo is not None:
        _report(tracer, slo, args.report)
    if args.profile_dir is not None:
        print(f"[serve] profile: torch.profiler trace -> {args.profile_dir}")
    if args.json is not None:
        dump = {
            "provenance": provenance(
                config=cfg.name, mode=args.compress or "dense",
                seed=args.seed, backend=backend, device=device,
                workload=args.workload, disagg=bool(args.disagg)),
            "metrics": m,
            "failed": [{"rid": f.rid, "reason": f.reason,
                        "retries": f.retries}
                       for f in (sess.failed if resil is not None else [])],
            "pages": pages,
        }
        if tracer is not None:
            dump["wall_phases"] = tracer.wall.summary()
        with open(args.json, "w") as f:
            json.dump(dump, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[serve] json: metrics -> {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Serving launcher of the port: timed traffic through `Engine`, optionally
compressed weights, on the card unless ``--device cpu`` asks for the
plain versions::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --compress aida --density 0.25 --requests 16 \\
      --workload heterogeneous --chunk 8 --policy sjf

Without ``--full-size`` the architecture is cut to its reduced size for a
quick functional serve; weights are random from the engine's seed.  The
flags and the ``[serve]`` lines are the JAX package's launcher's, less
those of slices the port has not taken yet (mesh, disaggregated roles,
fault injection, deadlines, retries).  Without a visible card and without
``--device cpu`` it stops with an error; it never falls back to the CPU.
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
                    choices=[None, "auto", "paged"],
                    help="None/auto = the page-pool KV cache wherever the "
                         "arch has attention")
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
                    help="write the run's metrics as machine-readable "
                         "JSON (with provenance)")
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
    from repro_torch.api.engine import resolve_device
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
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(2, f"[serve] {e}\n")

    cfg = get(args.arch) if args.full_size else reduced(get(args.arch))
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

    tracer = _tracer(ap, args, slo)
    sess = eng.session(batch_slots=args.slots, max_len=MAX_LEN,
                       kv_cache=args.kv_cache,
                       kv_pool_pages=args.kv_pool_pages,
                       scheduler=SchedConfig(
                           policy=args.policy, chunk=args.chunk,
                           prefix_cache=args.prefix_cache),
                       obs=tracer)
    paged = sess.alloc is not None
    print(f"[serve] workload={args.workload} seed={args.seed} "
          f"kv={'paged' if paged else 'full'} chunk={sess.chunk} "
          f"policy={args.policy}")
    t0 = time.perf_counter()
    with profile_trace(args.profile_dir):
        sess.run_workload(arrivals)
    dt = time.perf_counter() - t0
    m = summarize(sess.records, dt, sess.stats["steps"])
    print(f"[serve] {m['completed']}/{m['requests']} requests, "
          f"{m['tokens']} tokens, {m['tok_per_s']:.1f} tok/s, "
          f"goodput {m['goodput_req_per_s']:.2f} req/s "
          f"({m['steps']} model calls)")
    if m["ttft_s"]:
        print(f"[serve] TTFT p50 {m['ttft_s']['p50']*1e3:.0f} ms / "
              f"p99 {m['ttft_s']['p99']*1e3:.0f} ms; "
              f"preemptions {m['preemptions']}, "
              f"prefix pages reused {m['prefix_pages_reused']}")
    pages = None
    if paged:
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
                workload=args.workload),
            "metrics": m,
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

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
``--json``.  ``--mesh MODEL[xDATA]`` serves tensor-parallel
(`repro_torch.shard`): the launcher starts one process per rank, over
``nccl`` with a card a rank, or over ``gloo`` with ``--device cpu`` or
``--mesh-backend gloo`` (every rank on the one card); rank 0 alone prints
the report and writes the files, after checking that every rank served
the same tokens.  The flags and the ``[serve]`` lines are the JAX
package's launcher's, less ``--prefill-devices`` / ``--decode-devices``,
which wait for the role meshes.  Without a visible card and without
``--device cpu`` it stops with an error; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import List, Optional, Tuple

#: the launcher serves at this context length, as the JAX package's does
MAX_LEN = 128
#: seconds a --mesh serve's ranks may run before the launcher stops them
MESH_TIMEOUT = 3600.0


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
    ap.add_argument("--mesh", default=None, metavar="MODEL[xDATA]",
                    help="tensor-parallel serving mesh, MODEL or "
                         "MODELxDATA (e.g. 4 or 2x2): one process a rank "
                         "(repro_torch.shard)")
    ap.add_argument("--mesh-backend", default=None,
                    choices=[None, "nccl", "gloo"],
                    help="the mesh's collectives: nccl (default on the "
                         "card, a card a rank) or gloo (the default with "
                         "--device cpu; on the card every rank shares "
                         "cuda:0)")
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


def _parse_mesh(ap, arg: str) -> Tuple[int, Optional[int]]:
    """"4" -> model 4; "4x2" -> model 4, data 2."""
    parts = arg.lower().split("x")
    try:
        return int(parts[0]), int(parts[1]) if len(parts) > 1 else None
    except (ValueError, IndexError):
        ap.error(f"--mesh wants MODEL or MODELxDATA, got {arg!r}")


def _mesh_backend(ap, args, n: int) -> str:
    """The mesh's collective backend: gloo on the CPU, nccl on the card
    unless --mesh-backend gloo asks every rank onto one card."""
    import torch
    if args.device == "cpu":
        if args.mesh_backend == "nccl":
            ap.error("--mesh-backend nccl needs the card, not --device cpu")
        return "gloo"
    if args.device is not None:
        ap.error("a mesh on the card places its ranks itself; drop "
                 "--device (or pass --device cpu)")
    if not torch.cuda.is_available():
        ap.exit(2, "[serve] no CUDA device is visible; pass --device cpu "
                "for a mesh on the CPU\n")
    backend = args.mesh_backend or "nccl"
    if backend == "nccl" and torch.cuda.device_count() < n:
        ap.error(f"an nccl mesh of {n} ranks needs {n} cards, "
                 f"{torch.cuda.device_count()} are visible (--mesh-backend "
                 "gloo puts every rank on one card)")
    return backend


def _mesh_rank(rank: int, argv: List[str], backend: str) -> None:
    """One rank of ``--mesh``: the same serve on this rank's device, its
    output and files on rank 0 alone."""
    from repro_torch.launch.mesh import make_host_mesh
    ap = _parser()
    args = ap.parse_args(argv)
    n_model, n_data = _parse_mesh(ap, args.mesh)
    device = "cpu" if args.device == "cpu" else \
        f"cuda:{rank if backend == 'nccl' else 0}"
    mesh = make_host_mesh(n_model, n_data, backend=backend, device=device)
    if rank:
        args.json = args.trace = args.report = args.profile_dir = None
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet):
            _serve(ap, args, mesh)
    else:
        _serve(ap, args, mesh)


def main(argv: Optional[List[str]] = None) -> int:
    ap = _parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.mesh is None:
        return _serve(ap, args)
    if args.disagg:
        ap.error("--mesh and --disagg are mutually exclusive; give the "
                 "roles their own devices with --prefill-devices / "
                 "--decode-devices (not ported yet)")
    n_model, n_data = _parse_mesh(ap, args.mesh)
    n = n_model * (n_data or 1)
    if n_model < 1 or n < 1:
        ap.error(f"--mesh degrees must be >= 1, got {args.mesh!r}")
    backend = _mesh_backend(ap, args, n)
    from repro_torch.shard import comm
    comm.spawn(n, _mesh_rank, (argv, backend), backend=backend,
               timeout=MESH_TIMEOUT)
    return 0


def _serve(ap, args, mesh=None) -> int:
    """The serve itself: on one device, or as one rank of ``mesh``."""
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
    if mesh is not None:
        device = mesh.device
    else:
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
    if mesh is not None:
        from repro_torch.launch.mesh import mesh_shape_dict
        print(f"[serve] mesh: {mesh_shape_dict(mesh)} over {mesh.backend}, "
              f"one process a rank")
    sess = eng.session(batch_slots=args.slots, max_len=MAX_LEN,
                       kv_cache=args.kv_cache,
                       kv_pool_pages=args.kv_pool_pages,
                       scheduler=SchedConfig(
                           policy=args.policy, chunk=args.chunk,
                           prefix_cache=args.prefix_cache),
                       disagg=disagg, resil=resil, obs=tracer, mesh=mesh)
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
    if mesh is not None:
        _check_lockstep(sess, mesh)
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
                workload=args.workload, disagg=bool(args.disagg),
                mesh=None if mesh is None else {
                    "shape": dict(zip(mesh.axis_names, mesh.shape)),
                    "backend": mesh.backend}),
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


def _check_lockstep(sess, mesh) -> None:
    """Every rank ran the same host loop: their tokens (rid order) must be
    equal, or the serve fails."""
    import torch
    from repro_torch.shard import comm
    toks = [t for r in sorted(sess.results, key=lambda r: r.rid)
            for t in [r.rid, len(r.tokens), *r.tokens]]
    if not comm.all_equal(torch.tensor(toks, dtype=torch.int64,
                                       device=mesh.device)):
        raise RuntimeError("mesh ranks served different tokens")
    print(f"[serve] mesh: the {mesh.size} ranks served the same tokens")


if __name__ == "__main__":
    raise SystemExit(main())

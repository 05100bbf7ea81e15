"""Run the paper's Fig. 3 algorithm bit-for-bit on the CAM emulator, and
show the cycle model + Table-1-style projections for a real FC layer -
everything through the `repro_torch.api.Engine` facade (`ap-emulator` and
`cycle-sim` backends).

  PYTHONPATH=src python -m repro_torch.examples.aida_emulator_demo \\
      [--device cpu]
"""
import argparse
from typing import List, Optional

import numpy as np

from repro_torch.api import Engine, FCProblem


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the emulator's CAM lives (default: the "
                    "card)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    eng = Engine(device=args.device)

    print("== bit-serial mode (Fig. 3 verbatim) ==")
    W = rng.integers(-15, 16, size=(12, 16)) * (rng.random((12, 16)) < 0.4)
    b = rng.integers(-15, 16, size=(16,)) * (rng.random(16) < 0.6)
    prob = FCProblem(w=W, b=b, m=4, n=4)
    res = eng.estimate(backend="ap-emulator", workload=prob)
    print(f"  C = relu(W x B): emulator == oracle: {res['exact']}")
    print(f"  cycles={res['cycles']} (broadcast {res['nnz_b']} nnz acts, "
          f"{res['rounds']} soft-reduction rounds)")
    print(f"  compare ops={res['counters']['compare']} "
          f"writes={res['counters']['write']} "
          f"tag moves={res['counters']['move']}")
    sim = eng.estimate(backend="cycle-sim", workload=prob)
    print(f"  cycle-sim closed form: {sim['cycles']} cycles - "
          f"{'EXACT match' if sim['cycles'] == res['cycles'] else 'MISMATCH'}")

    print("\n== coded mode (bit-parallel perfect induction, 4-bit) ==")
    cw = np.concatenate([[0], rng.integers(-99, 100, 15)])
    ca = np.concatenate([[0], rng.integers(-99, 100, 15)])
    Wc = rng.integers(0, 16, size=(12, 16)) * (rng.random((12, 16)) < 0.4)
    bc = rng.integers(0, 16, size=(16,)) * (rng.random(16) < 0.6)
    cprob = FCProblem(w=Wc, b=bc, m=4, n=4, coded=True,
                      cents_w=cw, cents_a=ca)
    res = eng.estimate(backend="ap-emulator", workload=cprob)
    print(f"  emulator == oracle: {res['exact']}")
    print(f"  cycles={res['cycles']} - the multiply stage is 225 cycles "
          f"for ANY layer size (perfect induction)")

    print("\n== projected to AlexNet-FC6 (closed-form model) ==")
    alex = eng.estimate(backend="cycle-sim", workload="alexnet-fc")
    ph = alex["report"].phases[0]
    mc_total = alex["report"].cycles_total
    print(f"  FC6 broadcast={ph.broadcast} multiply={ph.multiply} "
          f"reduce={ph.reduce} cycles; network total={mc_total} "
          f"@1GHz = {mc_total/1e3:.1f} us")
    t1 = eng.estimate(backend="cycle-sim", workload="table1")
    a, e = t1["aida"], t1["eie"]
    print(f"  AIDA {a['pp_gops']:.0f} GOP/s vs EIE {e['pp_gops']:.0f} "
          f"-> {a['pp_gops']/e['pp_gops']:.1f}x (paper: 14.5x)")


if __name__ == "__main__":
    main()

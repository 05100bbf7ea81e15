"""EIE baseline model — the paper's comparison point (Han et al., ISCA'16).

AIDA's Table 1 compares against EIE, so the reproduction needs an EIE model.
Built from EIE's published microarchitecture: 64 processing elements (PEs),
800 MHz (28nm-scaled figure used by the AIDA paper), CSC-striped weight
storage, one MAC per PE per cycle on nonzero (weight × activation) pairs,
leading-nonzero-detect broadcast of nonzero activations.

Performance model:
  peak  = 2 ops × 64 PEs × f                           = 102.4 GOP/s ✓
  layer cycles ≈ (nnz touched by nonzero activations) / 64 × load_imbalance
  (EIE paper reports ~63% average PE utilization on real layers → default
   imbalance 1.6).

Energy convention (reverse-engineered from Table 1, see aida_sim docstring):
EIE's listed 2756 GOP/J counts DENSE-EQUIVALENT ops (≈10× weight sparsity) —
102.4 GOPs × 10 / 0.37 W = 2768 ≈ 2756.  We reproduce both conventions.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core.aida_sim import (FCLayerSpec, alexnet_fc,  # noqa
                                       ctc_lstm)


@dataclasses.dataclass(frozen=True)
class EIEConfig:
    n_pe: int = 64
    freq_hz: float = 800e6          # Table 1 (28nm scaled)
    power_w: float = 0.37           # Table 1 (28nm scaled)
    load_imbalance: float = 1.6     # ≈1/0.63 PE utilization (EIE paper)
    act_queue_overhead: float = 1.05  # broadcast FIFO stalls


def layer_cycles(l: FCLayerSpec, cfg: EIEConfig = EIEConfig()) -> float:
    """Cycles for one sparse M×V on EIE.

    Work = nonzeros in the columns selected by nonzero activations
         ≈ nnz × a_density, spread over 64 PEs with imbalance.
    """
    work = l.nnz * l.a_density
    return work / cfg.n_pe * cfg.load_imbalance * cfg.act_queue_overhead


@dataclasses.dataclass
class EIEReport:
    name: str
    cycles_total: float
    peak_gops: float
    effective_gops: float
    inf_per_s: float
    power_w: float
    ee_sparse_gop_j: float
    ee_dense_equiv_gop_j: float


def evaluate_network(name: str, layers: Sequence[FCLayerSpec],
                     cfg: EIEConfig = EIEConfig()) -> EIEReport:
    cyc = sum(layer_cycles(l, cfg) for l in layers)
    t = cyc / cfg.freq_hz
    ops = 2 * sum(l.nnz * l.a_density for l in layers)  # MACs actually done
    dense_ops = 2 * sum(l.n_out * l.n_in for l in layers)
    peak = 2 * cfg.n_pe * cfg.freq_hz / 1e9
    eff = ops / t / 1e9
    return EIEReport(
        name=name, cycles_total=cyc, peak_gops=peak,
        effective_gops=eff, inf_per_s=1.0 / t, power_w=cfg.power_w,
        ee_sparse_gop_j=peak / cfg.power_w,
        ee_dense_equiv_gop_j=(dense_ops / t / 1e9) / cfg.power_w)


def eie_table1(cfg: EIEConfig = EIEConfig()) -> dict:
    alex = evaluate_network("AlexNet-FC", alexnet_fc(), cfg)
    ctc = evaluate_network("CTC-3L-421H-UNI", ctc_lstm(), cfg)
    return dict(alexnet=alex, ctc=ctc,
                pp_gops=alex.peak_gops,
                thrpt_inf_s=ctc.inf_per_s,
                power_w=cfg.power_w,
                ee_gop_per_j=2756.0,  # EIE's listed (dense-equivalent) figure
                ee_model_dense_equiv=ctc.ee_dense_equiv_gop_j)

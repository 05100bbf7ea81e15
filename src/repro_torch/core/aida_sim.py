"""Analytical AIDA simulator — performance / power / area model (§4).

The paper evaluates AIDA with "a custom simulator ... for performance and
power simulation and design space exploration".  This module is that
simulator, rebuilt from the Fig. 3 algorithm (pure Python, the same
numbers as the JAX package's copy):

* **cycles** — closed-form counts derived op-by-op from the emulator's
  micro-operations.  With the ``EMULATOR`` microcode preset the closed form
  equals `aida_fc.aida_fc_layer`'s measured cycle counter EXACTLY
  (the tests assert this).  The ``PAPER`` preset uses the
  more aggressive microcode the paper's headline numbers imply (fused
  compare+write in the reduction move loop, 8-cycle full adder, 16-bit
  saturating accumulator, broadcast overlapped with M×V per §4.3) and is
  used to reproduce Table 1.
* **energy/power** — per-cycle CAM/TAG activity model calibrated against
  the paper's published cell figures (TAG 7.1 µm² & 5.6 fJ, 10T NOR CAM
  bitcell 0.135 µm² @28 nm) and reported alongside the claimed 7.15 W.
* **area/memory** — rows × (bits × cell area + TAG) with periphery factor.

Conventions reverse-engineered from Table 1:
AIDA EE = PP/Power on *sparse* ops (1474/7.15 = 206.2 ✓); EIE's listed EE
counts *dense-equivalent* ops (≈10× sparsity: 102.4×10/0.37 = 2768 ≈ 2756 ✓).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core.associative import move_cycles


# ------------------------------------------------------------ microcode
@dataclasses.dataclass(frozen=True)
class Microcode:
    """Per-primitive cycle costs + controller policy knobs."""
    c_and: int = 2            # perfect-induction bitwise AND
    c_fulladd: int = 10       # snapshot(4) + 6 written truth-table entries
    c_halfadd: int = 6
    fused_reduce_move: bool = False  # compare+write fused around tag moves
    kc_fixed: Optional[int] = None   # None = exact-width accumulator
    overlap_broadcast: bool = False  # §4.3 two-subarray pipelining
    freq_hz: float = 1.0e9           # Table 1: 1000 MHz


EMULATOR = Microcode()
PAPER = Microcode(c_fulladd=8, c_halfadd=5, fused_reduce_move=True,
                  kc_fixed=16, overlap_broadcast=True)


# ------------------------------------------------------------ cycle model
def acc_kc(m: int, n: int, max_row_nnz: int, mc: Microcode,
           prod_bits: Optional[int] = None) -> int:
    """Accumulator width: product bits + tree headroom + sign."""
    if mc.kc_fixed is not None:
        return mc.kc_fixed
    pb = (m + n) if prod_bits is None else prod_bits
    acc = math.ceil(math.log2(max_row_nnz)) if max_row_nnz > 1 else 0
    return pb + acc + 1


def reduction_rounds(max_row_nnz: int) -> int:
    return max(1, math.ceil(math.log2(max_row_nnz))) if max_row_nnz > 1 else 1


def cycles_broadcast(nnz_b: int) -> int:
    """Lines 2–5: one fused compare+write per nonzero activation."""
    return nnz_b


def cycles_multiply_bitserial(m: int, n: int, kc: int, mc: Microcode) -> int:
    """Lines 7–12 + sign fix: schoolbook bit-serial multiply."""
    inner = n * m * (mc.c_and + mc.c_fulladd)
    ripple = mc.c_halfadd * (n * (n + 1) // 2)
    sign = 3 + 4 * kc + (2 + mc.c_fulladd + mc.c_halfadd * (kc - 1) + 1)
    return inner + ripple + sign


def cycles_multiply_coded(cw_bits: int, ca_bits: int) -> int:
    """Bit-parallel perfect induction: every nonzero code combination."""
    return ((1 << cw_bits) - 1) * ((1 << ca_bits) - 1)


def cycles_reduction(kc: int, max_row_nnz: int, mc: Microcode) -> int:
    """Lines 14–26: binary-tree segmented accumulation."""
    total = 0
    for t in range(reduction_rounds(max_row_nnz)):
        mcyc = move_cycles(1 << t)
        per_bit = (1 if mc.fused_reduce_move else 2) + mcyc
        total += (1                       # clear MV
                  + (kc + 1) * per_bit    # tag, shift, deposit (C bits + flag)
                  + mc.c_fulladd * kc + 1  # C += MV, clear carry
                  + 1 + 1 + 2)            # fold LAST, kill senders, check
    return total


def cycles_relu() -> int:
    return 1  # lines 28–29, fused compare+write


@dataclasses.dataclass
class FCPhases:
    broadcast: int
    multiply: int
    reduce: int
    act: int

    @property
    def compute(self) -> int:  # everything that cannot overlap broadcast
        return self.multiply + self.reduce + self.act

    def total(self, mc: Microcode) -> int:
        if mc.overlap_broadcast:  # §4.3 two-subarray pipelining
            return max(self.broadcast, self.compute)
        return self.broadcast + self.compute


def cycles_fc(n_in: int, nnz_b: int, max_row_nnz: int, mc: Microcode,
              mode: str = "coded", m: int = 4, n: int = 4,
              prod_bits: int = 16) -> FCPhases:
    """Full FC-layer cycle breakdown.

    mode="coded": m/n are the CODE widths (4-bit), prod_bits the product
    wordlength (16-bit values — Table 1's 'Quant 16/16').
    mode="bitserial": m/n are the operand wordlengths.
    """
    del n_in
    if mode == "coded":
        kc = acc_kc(m, n, max_row_nnz, mc, prod_bits=prod_bits)
        mul = cycles_multiply_coded(m, n)
    elif mode == "bitserial":
        kc = acc_kc(m, n, max_row_nnz, mc)
        mul = cycles_multiply_bitserial(m, n, kc, mc)
    else:
        raise ValueError(mode)
    red = cycles_reduction(kc, max_row_nnz, mc)
    return FCPhases(broadcast=cycles_broadcast(nnz_b), multiply=mul,
                    reduce=red, act=cycles_relu())


# ---------------------------------------------------------- energy / area
@dataclasses.dataclass(frozen=True)
class Tech:
    """28nm figures; cell numbers from the paper, activity factors
    calibrated once against Table 1's 7.15 W."""
    a_cam_cell_um2: float = 0.135   # paper §4.2: 10T NOR CAM bitcell
    a_tag_um2: float = 7.1          # paper §4.2: synthesized TAG cell
    e_tag_fj: float = 5.6           # paper §4.2: average TAG energy
    e_cmp_fj_per_bit: float = 0.07  # match-line bitcell compare (calibrated)
    e_wr_fj_per_bit: float = 0.30   # write driver per bitcell
    tag_activity: float = 0.03      # fraction of TAGs toggling per compare
    write_sel_frac: float = 0.15    # average fraction of rows tagged
    avg_cmp_bits: float = 9.0       # average masked-key width
    avg_wr_bits: float = 8.0
    periphery: float = 1.15         # drivers/decoders/controller overhead


TECH = Tech()


def row_energy_per_cycle_fj(tech: Tech = TECH) -> float:
    """Average CAM energy per PU row per controller cycle (fJ)."""
    return (tech.avg_cmp_bits * tech.e_cmp_fj_per_bit
            + tech.tag_activity * tech.e_tag_fj
            + tech.write_sel_frac * tech.avg_wr_bits * tech.e_wr_fj_per_bit)


def power_w(active_rows: int, mc: Microcode, tech: Tech = TECH) -> float:
    return active_rows * row_energy_per_cycle_fj(tech) * 1e-15 * mc.freq_hz


def area_mm2(rows: int, bits_per_row: int, tech: Tech = TECH,
             dual_tag: bool = False) -> float:
    tag = tech.a_tag_um2 * (2 if dual_tag else 1)
    return rows * (bits_per_row * tech.a_cam_cell_um2 + tag) \
        * tech.periphery / 1e6


def memory_mbytes(rows: int, stored_bits: int) -> float:
    """On-chip capacity counting STORED fields (flag+rel-col+W code)."""
    return rows * stored_bits / 8 / 1e6


# ------------------------------------------------------------- workloads
@dataclasses.dataclass(frozen=True)
class FCLayerSpec:
    name: str
    n_out: int
    n_in: int
    w_density: float     # Deep-Compression weight density
    a_density: float     # input activation density
    row_max_factor: float = 2.0  # max-row-nnz / mean-row-nnz (imbalance)

    @property
    def nnz(self) -> int:
        return int(self.n_out * self.n_in * self.w_density)

    @property
    def nnz_b(self) -> int:
        return int(self.n_in * self.a_density)

    @property
    def max_row_nnz(self) -> int:
        return max(1, min(self.n_in,
                          int(self.n_in * self.w_density
                              * self.row_max_factor)))


def alexnet_fc() -> List[FCLayerSpec]:
    """AlexNet FC6/7/8 with Deep-Compression densities (EIE Table II:
    9%/9%/25% weights, ~35% activations)."""
    return [FCLayerSpec("FC6", 4096, 9216, 0.09, 0.35),
            FCLayerSpec("FC7", 4096, 4096, 0.09, 0.35),
            FCLayerSpec("FC8", 1000, 4096, 0.25, 0.38)]


def ctc_lstm() -> List[FCLayerSpec]:
    """CTC-3L-421H-UNI (Graves 2013): 3 unidirectional LSTM layers,
    421 hidden; the recurrent+input FC block per layer is one 1684×842
    (4 gates × 421 out, 421+421 in) M×V.  10% weights; LSTM hidden
    activations are near-dense (0.9) and pruned-LSTM rows are close to
    uniform (max/mean ≈ 1.3) — both calibrated against the EIE/AIDA
    Table-1 throughput rows."""
    gates = 4 * 421
    return [FCLayerSpec(f"LSTM{i}", gates, 842, 0.10, 0.90,
                        row_max_factor=1.3) for i in range(3)]


# ------------------------------------------------------------ aggregates
@dataclasses.dataclass
class NetworkReport:
    name: str
    layers: List[FCLayerSpec]
    phases: List[FCPhases]
    cycles_total: int           # single-frame latency (sequential layers)
    cycles_pipe: int            # pipelined initiation interval (max layer)
    nnz_total: int
    gops_latency: float         # 2·nnz / latency
    gops_pipelined: float       # 2·nnz / II  == peak performance
    inf_per_s: float
    power_w: float
    ee_gop_per_j: float


def evaluate_network(name: str, layers: Sequence[FCLayerSpec],
                     mc: Microcode = PAPER, mode: str = "coded",
                     m: int = 4, n: int = 4, prod_bits: int = 16,
                     tech: Tech = TECH) -> NetworkReport:
    phases = [cycles_fc(l.n_in, l.nnz_b, l.max_row_nnz, mc, mode=mode,
                        m=m, n=n, prod_bits=prod_bits) for l in layers]
    totals = [p.total(mc) for p in phases]
    cyc_total = sum(totals)
    cyc_pipe = max(totals)
    nnz = sum(l.nnz for l in layers)
    t_total = cyc_total / mc.freq_hz
    t_pipe = cyc_pipe / mc.freq_hz
    pw = power_w(nnz, mc, tech)
    gops_pipe = 2 * nnz / t_pipe / 1e9
    return NetworkReport(
        name=name, layers=list(layers), phases=phases,
        cycles_total=cyc_total, cycles_pipe=cyc_pipe, nnz_total=nnz,
        gops_latency=2 * nnz / t_total / 1e9,
        gops_pipelined=gops_pipe,
        inf_per_s=1.0 / t_total,
        power_w=pw,
        ee_gop_per_j=gops_pipe / pw)


def peak_gops(layers: Sequence[FCLayerSpec], mc: Microcode = PAPER,
              mode: str = "coded", m: int = 4, n: int = 4,
              prod_bits: int = 16) -> float:
    """Peak performance: best per-layer rate over the compute phases
    (multiply + soft reduction — every resident PU busy; the broadcast is
    I/O and is excluded from the *peak* figure, matching how 1474 GOP/s
    relates to the Fig.-3 compute stages)."""
    best = 0.0
    for l in layers:
        ph = cycles_fc(l.n_in, l.nnz_b, l.max_row_nnz, mc, mode=mode,
                       m=m, n=n, prod_bits=prod_bits)
        rate = 2 * l.nnz / ((ph.multiply + ph.reduce) / mc.freq_hz) / 1e9
        best = max(best, rate)
    return best


def aida_table1(mc: Microcode = PAPER, tech: Tech = TECH) -> dict:
    """Reproduce AIDA's Table-1 column: PP over the AlexNet FC compute
    phases, throughput on CTC frames (broadcast overlapped, §4.3)."""
    alex = evaluate_network("AlexNet-FC", alexnet_fc(), mc, tech=tech)
    ctc = evaluate_network("CTC-3L-421H-UNI", ctc_lstm(), mc, tech=tech)
    nnz_all = alex.nnz_total + ctc.nnz_total
    pp_gops = peak_gops(alexnet_fc(), mc)
    pw = power_w(nnz_all, mc, tech)
    stored_bits = 2 + 4 + 4  # flag + EIE-style relative col index + W code
    bits_row = 2 + 1 + 10 + 4 + 4 + 4 + 16 + 17 + 6  # full compute layout
    return dict(
        alexnet=alex, ctc=ctc,
        pp_gops=pp_gops,
        thrpt_inf_s=ctc.inf_per_s,
        power_w=pw,
        ee_gop_per_j=pp_gops / pw,
        area_mm2=area_mm2(nnz_all, bits_row, tech),
        area_mm2_maxlayer=area_mm2(
            max(l.nnz for l in alexnet_fc()), bits_row, tech),
        memory_mb=memory_mbytes(nnz_all, stored_bits),
        nnz_total=nnz_all,
    )

"""Paper Fig. 3 — the AIDA FC-layer algorithm, executed on the AP emulator.

Stages (all massively parallel across PUs = CAM rows):
  1. activation broadcast — per nonzero activation: one fused
     compare+write (paper lines 2–5, "lines 3 and 4 are executed in
     parallel"),
  2. multiplication — bit-serial schoolbook multiply of every (W, B) pair
     at once, each single-bit op realized by perfect induction (lines
     7–12),
  3. soft reduction — binary-tree segmented accumulation steered by the
     ACSR row flags; odd partials are tag-Moved onto even ones and added
     bit-serially until every '10' (last) flag merges into its '01'
     (first), turning it '11' (lines 14–26),
  4. activation function — ReLU: match the sign bit, write zeros (lines
     28–29).

Elaborations beyond the paper's pseudocode, as in the JAX package:
two's-complement product / accumulator with an explicit sign fix (the
paper leaves signed arithmetic unspecified), a per-PU local-position
field POS keying the tree senders (precomputable at encode time, so every
controller step stays data-independent), and a dedicated move-receive
field MV (the paper reuses the B field).

Every step is issued through AP primitives in the JAX package's order,
call for call, so ``ap.counters`` afterwards holds the exact cycle count;
`aida_sim.cycles_fc` reproduces it in closed form.  The host I/O is
vectorised: the CAM image is loaded and the results read as bit
decompositions of the ACSR stream on the device, and the controller's
per-step keys (one row per broadcast activation, per coded product) are
built once and copied to the device in one piece.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import acsr as acsr_mod
from repro_torch.core.associative import AP, Field, move_cycles  # noqa: F401
from repro_torch.core.device import resolve_device


@dataclasses.dataclass
class Layout:
    """CAM bit-column layout for one FC layer instance."""
    flag: Field      # 2 bits: bit0 = FIRST, bit1 = LAST  ('01','10','11')
    alive: Field     # 1 bit
    pos: Field       # local index within the matrix-row segment
    col_idx: Field   # column index of the nonzero weight
    w: Field         # weight magnitude, m bits
    w_sign: Field    # 1 bit
    b: Field         # activation magnitude, n bits
    b_sign: Field    # 1 bit
    c: Field         # accumulator, two's complement, kc bits
    mv: Field        # move-receive buffer, kc bits
    mv_last: Field   # 1 bit: moved LAST flag
    t: Field         # 1 bit: AND result
    carry: Field     # 1 bit
    scr: Field       # 1 bit: carry/bit snapshot
    scr_a: Field     # 1 bit: addend snapshot
    psign: Field     # 1 bit: product sign
    total_bits: int


def make_layout(m: int, n: int, ci_bits: int, pos_bits: int,
                kc: int) -> Layout:
    base = 0
    fields = {}
    for name, width in [("flag", 2), ("alive", 1), ("pos", pos_bits),
                        ("col_idx", ci_bits), ("w", m), ("w_sign", 1),
                        ("b", n), ("b_sign", 1), ("c", kc), ("mv", kc),
                        ("mv_last", 1), ("t", 1), ("carry", 1), ("scr", 1),
                        ("scr_a", 1), ("psign", 1)]:
        fields[name] = Field(base, width)
        base += width
    return Layout(total_bits=base, **fields)


def _bits(v: np.ndarray, width: int) -> np.ndarray:
    """[k] int64 -> [k, width] uint8, LSB first (two's complement)."""
    return ((v[:, None] >> np.arange(width)) & 1).astype(np.uint8)


# --------------------------------------------------------- micro-operations
def clear_bits(ap: AP, cols) -> None:
    """Tag all rows (empty compare mask) + parallel write zeros: 1 cycle."""
    cols = np.atleast_1d(np.asarray(cols))
    ap.compare_write([], [], cols, np.zeros(cols.size, np.uint8))


def bit_and(ap: AP, dst: int, a: int, b: int) -> None:
    """dst = a & b by perfect induction: clear + match the single 1-entry."""
    clear_bits(ap, [dst])
    ap.compare_write([a, b], [1, 1], [dst], [1])


def snapshot(ap: AP, src: int, dst: int) -> None:
    """dst = src (2 cycles: clear, conditional set)."""
    clear_bits(ap, [dst])
    ap.compare_write([src], [1], [dst], [1])


def full_add(ap: AP, a: int, b: int, carry: int, scr: int, scr_a: int) -> None:
    """(a, carry) = a + b + carry, in-place, by perfect induction.

    Keys match snapshots (scr_a, b, scr) — none written — so truth-table
    order is irrelevant.  Entries 000 and 111 are fixed points (no write).
    10 cycles, data-independent.
    """
    snapshot(ap, carry, scr)
    snapshot(ap, a, scr_a)
    for av, bv, cv in [(0, 0, 1), (0, 1, 0), (0, 1, 1),
                       (1, 0, 0), (1, 0, 1), (1, 1, 0)]:
        s = av ^ bv ^ cv
        cout = (av & bv) | (cv & (av | bv))
        ap.compare_write([scr_a, b, scr], [av, bv, cv],
                         [a, carry], [s, cout])


def half_add(ap: AP, a: int, carry: int, scr: int, scr_a: int) -> None:
    """(a, carry) = a + carry (carry ripple step). 6 cycles."""
    snapshot(ap, carry, scr)
    snapshot(ap, a, scr_a)
    ap.compare_write([scr_a, scr], [0, 1], [a, carry], [1, 0])
    ap.compare_write([scr_a, scr], [1, 1], [a, carry], [0, 1])


# ------------------------------------------------------------- the FC layer
def load_cam(ap: AP, lay: Layout, a: acsr_mod.ACSR,
             w_int: torch.Tensor) -> torch.Tensor:
    """DMA the ACSR image into the CAM (not cycle-counted): flags, ALIVE,
    each PU's position in its matrix row, column index, |w| and w's sign,
    for the ``a.nnz`` populated rows, as bit decompositions on the device.
    ``w_int``: the [ap.rows] int64 weight stream.  Returns the per-PU local
    positions (for assertions only)."""
    nnz = a.nnz
    pos = torch.zeros(ap.rows, dtype=torch.int64, device=ap.device)
    if not nnz:
        return pos
    flags = a.row_flag[:nnz].long()
    idx = torch.arange(nnz, device=ap.device)
    first = (flags & acsr_mod.FLAG_FIRST) != 0
    pos[:nnz] = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    ap.load_fields(lay.flag, flags)
    ap.load_fields(lay.alive, torch.ones_like(flags))
    ap.load_fields(lay.pos, pos[:nnz])
    ap.load_fields(lay.col_idx, a.col_idx[:nnz].long())
    wv = w_int[:nnz]
    ap.load_fields(lay.w, wv.abs())
    ap.load_fields(lay.w_sign, (wv < 0).long())
    return pos


def broadcast(ap: AP, lay: Layout, b_int: np.ndarray) -> int:
    """Stage 1 (lines 2–5): one fused compare+write per nonzero activation
    (zero activations are never broadcast).  Each activation's key (its
    index) and bits (|b|, sign) are one row of a table built once."""
    b_int = np.asarray(b_int, np.int64)
    idx = np.nonzero(b_int)[0]
    val = b_int[idx]
    ci = lay.col_idx.width
    table = np.concatenate([_bits(idx, ci), _bits(np.abs(val), lay.b.width),
                            (val < 0).astype(np.uint8)[:, None]], axis=1)
    table = torch.from_numpy(table).to(ap.device)
    ccols = lay.col_idx.cols()
    wcols = np.concatenate([lay.b.cols(), lay.b_sign.cols()])
    for row in table:
        ap.compare_write(ccols, row[:ci], wcols, row[ci:])
    return int(idx.size)


def multiply(ap: AP, lay: Layout) -> None:
    """Stage 2 (lines 7–12): bit-serial W×B into C, all PUs in parallel."""
    m, n, kc = lay.w.width, lay.b.width, lay.c.width
    t, carry = lay.t.col(0), lay.carry.col(0)
    scr, scr_a = lay.scr.col(0), lay.scr_a.col(0)
    for j in range(n):
        for i in range(m):
            bit_and(ap, t, lay.w.col(i), lay.b.col(j))
            full_add(ap, lay.c.col(i + j), t, carry, scr, scr_a)
        # worst-case (data-independent) carry ripple to the product top bit
        for p in range(j + m, m + n):
            half_add(ap, lay.c.col(p), carry, scr, scr_a)
    # sign fix: psign = w_sign XOR b_sign; negate C on negative products
    ps = lay.psign.col(0)
    clear_bits(ap, [ps])
    ap.compare_write([lay.w_sign.col(0), lay.b_sign.col(0)], [1, 0], [ps], [1])
    ap.compare_write([lay.w_sign.col(0), lay.b_sign.col(0)], [0, 1], [ps], [1])
    for bpos in range(kc):  # bitwise NOT on tagged rows (4 cycles/bit)
        cb = lay.c.col(bpos)
        snapshot(ap, cb, scr)
        ap.compare_write([ps, scr], [1, 0], [cb], [1])
        ap.compare_write([ps, scr], [1, 1], [cb], [0])
    clear_bits(ap, [t])                       # +1 via T column
    ap.compare_write([ps], [1], [t], [1])
    full_add(ap, lay.c.col(0), t, carry, scr, scr_a)
    for p in range(1, kc):
        half_add(ap, lay.c.col(p), carry, scr, scr_a)
    clear_bits(ap, [carry])


def soft_reduction(ap: AP, lay: Layout) -> int:
    """Stage 3 (lines 14–26): segmented binary-tree accumulation.

    Returns the number of rounds executed (paper: do-while any '10' alive).
    """
    kc = lay.c.width
    carry = lay.carry.col(0)
    scr, scr_a = lay.scr.col(0), lay.scr_a.col(0)
    rounds = 0
    while True:
        d = 1 << rounds
        # sender key: POS ≡ 2^t (mod 2^{t+1}) and ALIVE
        pos_cols = lay.pos.cols(0, min(rounds + 1, lay.pos.width))
        pos_key = [0] * (len(pos_cols) - 1) + [1] if len(pos_cols) > rounds \
            else [0] * len(pos_cols)
        sender_cols = np.concatenate([pos_cols, lay.alive.cols()])
        sender_key = np.array(pos_key + [1], np.uint8)

        clear_bits(ap, np.concatenate([lay.mv.cols(), lay.mv_last.cols()]))
        # per-bit: tag sender bits, shift tags up by d, deposit into MV
        move_srcs = [(lay.c.col(bpos), lay.mv.col(bpos)) for bpos in range(kc)]
        move_srcs.append((lay.flag.col(1), lay.mv_last.col(0)))  # LAST flag
        for src, dst in move_srcs:
            ap.compare(np.concatenate([sender_cols, [src]]),
                       np.concatenate([sender_key, [1]]))
            ap.move_by("up", d)
            ap.write([dst], [1])
        # receivers accumulate: C += MV  (runs on all PUs; MV=0 elsewhere)
        for bpos in range(kc):
            full_add(ap, lay.c.col(bpos), lay.mv.col(bpos), carry, scr, scr_a)
        clear_bits(ap, [carry])
        # fold the moved LAST flag: '01' head that received it becomes '11'
        ap.compare_write(lay.mv_last.cols(), [1], [lay.flag.col(1)], [1])
        # senders die
        ap.compare_write(sender_cols, sender_key, lay.alive.cols(), [0])
        rounds += 1
        # completion check (lines 25–26): any ALIVE row still flagged '10'?
        ap.compare([lay.flag.col(0), lay.flag.col(1), lay.alive.col(0)],
                   [0, 1, 1])
        if not ap.if_match():
            return rounds


def relu(ap: AP, lay: Layout) -> None:
    """Stage 4 (lines 28–29): match sign bit, write zeros. One fused cycle."""
    kc = lay.c.width
    ap.compare_write([lay.c.col(kc - 1)], [1],
                     lay.c.cols(), np.zeros(kc, np.uint8))


# ---------------------------------------------------- coded (bit-parallel)
def multiply_coded(ap: AP, lay: Layout, cents_w: np.ndarray,
                   cents_a: np.ndarray) -> int:
    """Bit-parallel perfect induction (§3): traverse all multiplier×
    multiplicand code combinations, substitute precomputed products.

    One fused compare+write per (w_code, a_code) pair — for 4-bit codebooks
    that is 15×15 = 225 cycles for the ENTIRE multiplication stage,
    independent of nnz.  Code 0 is the structural zero (product 0 = the
    preloaded C), so zero combos are skipped.  Returns cycles spent.
    """
    cw_bits, ca_bits = lay.w.width, lay.b.width
    kc = lay.c.width
    wc = np.repeat(np.arange(1, 1 << cw_bits), (1 << ca_bits) - 1)
    ac = np.tile(np.arange(1, 1 << ca_bits), (1 << cw_bits) - 1)
    prod = (np.asarray(cents_w, np.int64)[wc]
            * np.asarray(cents_a, np.int64)[ac])
    table = np.concatenate([_bits(wc, cw_bits), _bits(ac, ca_bits),
                            _bits(prod, kc)], axis=1)  # 2's complement
    table = torch.from_numpy(table).to(ap.device)
    ccols = np.concatenate([lay.w.cols(), lay.b.cols()])
    n_key = cw_bits + ca_bits
    for row in table:
        ap.compare_write(ccols, row[:n_key], lay.c.cols(), row[n_key:])
    return int(table.shape[0])


def _read_out(ap: AP, lay: Layout, a: acsr_mod.ACSR,
              n_rows: int) -> torch.Tensor:
    """Head PUs (FIRST or ONLY flag) hold the row results: C read as two's
    complement of its width, scattered to their matrix rows."""
    out = torch.zeros(n_rows, dtype=torch.int64, device=ap.device)
    heads = torch.nonzero(
        (a.row_flag[: a.nnz] & acsr_mod.FLAG_FIRST) != 0).squeeze(1)
    out[a.seg_id[heads].long()] = ap.read_fields(lay.c, heads, signed=True)
    return out


def _sync(device: torch.device) -> float:
    """The host clock once the device has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _row_widths(w: np.ndarray) -> tuple:
    """(max_row_nnz, pos_bits, ci_bits) of a weight matrix."""
    max_row_nnz = acsr_mod.max_row_nnz(w)
    pos_bits = max(1, math.ceil(math.log2(max_row_nnz))) \
        if max_row_nnz > 1 else 1
    ci_bits = max(1, math.ceil(math.log2(max(w.shape[1], 2))))
    return max_row_nnz, pos_bits, ci_bits


def _run(w: np.ndarray, b: np.ndarray, lay_args: tuple, max_row_nnz: int,
         activation, block: int, device, multiply_stage) -> "FCResult":
    """Encode, load, run the four stages and read out (the two drivers'
    common body); ``seconds`` splits the wall time into the encode and
    CAM load (host work and one copy) and the run."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    a = acsr_mod.encode(w, block=block, device=device)
    lay = make_layout(*lay_args)
    ap = AP(rows=a.nnz_pad, bits=lay.total_bits, device=device)
    w_stream = torch.zeros(ap.rows, dtype=torch.int64, device=device)
    w_stream[: a.nnz] = a.values[: a.nnz].long()
    load_cam(ap, lay, a, w_stream)
    t1 = _sync(device)

    nnz_b = broadcast(ap, lay, b)
    multiply_stage(ap, lay)
    rounds = soft_reduction(ap, lay)
    if activation == "relu":
        relu(ap, lay)
    out = _read_out(ap, lay, a, w.shape[0])
    counters = ap.counters
    t2 = _sync(device)
    return FCResult(out=out, cycles=counters["cycles"], rounds=rounds,
                    nnz_b=nnz_b, counters=counters, layout=lay,
                    max_row_nnz=max_row_nnz, ap=ap,
                    seconds={"encode_load": t1 - t0, "run": t2 - t1})


def aida_fc_layer_coded(w_codes: np.ndarray, b_codes: np.ndarray,
                        cents_w: np.ndarray, cents_a: np.ndarray,
                        activation: Optional[str] = "relu",
                        block: int = 1, device=None) -> "FCResult":
    """Coded-mode FC layer: 4-bit weight/activation codes, product LUT.

    w_codes: [N, K] uint (0 = structural zero), cents_w/cents_a: integer
    codebooks with cents[0] == 0.  This is AIDA's compressed-network
    configuration (the one benchmarked in Table 1).  Runs on ``device``
    (None: the card).
    """
    w_codes = np.asarray(w_codes, dtype=np.int64)
    b_codes = np.asarray(b_codes, dtype=np.int64)
    cents_w = np.asarray(cents_w, dtype=np.int64)
    cents_a = np.asarray(cents_a, dtype=np.int64)
    if cents_w[0] != 0 or cents_a[0] != 0:
        raise ValueError("code 0 is the structural zero")
    cw_bits = max(1, math.ceil(math.log2(len(cents_w))))
    ca_bits = max(1, math.ceil(math.log2(len(cents_a))))
    max_row_nnz, pos_bits, ci_bits = _row_widths(w_codes)
    pmax = int(np.abs(np.outer(cents_w, cents_a)).max())
    prod_bits = max(1, math.ceil(math.log2(pmax + 1)))
    acc_bits = max(0, math.ceil(math.log2(max_row_nnz))) \
        if max_row_nnz > 1 else 0
    kc = prod_bits + acc_bits + 1
    # the W field takes |code| (codes >= 0), the B field b's codes
    return _run(w_codes, b_codes, (cw_bits, ca_bits, ci_bits, pos_bits, kc),
                max_row_nnz, activation, block, device,
                lambda ap, lay: multiply_coded(ap, lay, cents_w, cents_a))


def fc_reference_coded(w_codes, b_codes, cents_w, cents_a,
                       activation: Optional[str] = "relu") -> np.ndarray:
    """Plain integer oracle of the coded layer (host, int64)."""
    w = np.asarray(cents_w)[np.asarray(w_codes, np.int64)]
    b = np.asarray(cents_a)[np.asarray(b_codes, np.int64)]
    out = w.astype(np.int64) @ b.astype(np.int64)
    if activation == "relu":
        out = np.maximum(out, 0)
    return out


# ------------------------------------------------------------------ driver
@dataclasses.dataclass
class FCResult:
    out: torch.Tensor          # [n_rows] int64 output activations (device)
    cycles: int
    rounds: int
    nnz_b: int
    counters: dict
    layout: Layout
    max_row_nnz: int
    ap: Optional[AP] = None    # the AP after the run (its CAM image)
    seconds: Optional[dict] = None  # wall: encode + CAM load, then the run


def aida_fc_layer(w_int: np.ndarray, b_int: np.ndarray, m: int, n: int,
                  activation: Optional[str] = "relu",
                  block: int = 1, device=None) -> FCResult:
    """Run one FC layer C = f(W×B) through the emulator on ``device``
    (None: the card).

    w_int: [N, K] integer weight matrix (|w| < 2^m), b_int: [K] (|b| < 2^n).
    """
    w_int = np.asarray(w_int, dtype=np.int64)
    b_int = np.asarray(b_int, dtype=np.int64)
    if np.abs(w_int).max(initial=0) >= 1 << m:
        raise ValueError(f"|w| must be below 2^{m}")
    if np.abs(b_int).max(initial=0) >= 1 << n:
        raise ValueError(f"|b| must be below 2^{n}")
    max_row_nnz, pos_bits, ci_bits = _row_widths(w_int)
    acc_bits = max(1, math.ceil(math.log2(max(max_row_nnz, 1)))) \
        if max_row_nnz > 1 else 0
    kc = m + n + acc_bits + 1
    return _run(w_int, b_int, (m, n, ci_bits, pos_bits, kc), max_row_nnz,
                activation, block, device, multiply)


def fc_reference(w_int: np.ndarray, b_int: np.ndarray,
                 activation: Optional[str] = "relu") -> np.ndarray:
    """Plain integer matvec oracle (host, int64)."""
    out = np.asarray(w_int, np.int64) @ np.asarray(b_int, np.int64)
    if activation == "relu":
        out = np.maximum(out, 0)
    return out

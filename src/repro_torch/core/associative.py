"""Bit-level associative processor (AP) emulator — paper §2.1–2.2, Fig. 1.

Functional model of AIDA's hardware primitives, on a torch device:

* a CAM array of ``rows × bits`` cells (one data element per row = one
  PU), held as a uint8 tensor ``[bits, rows]`` so each bit column is
  contiguous,
* ``compare(cols, key)``  — match key against the unmasked columns of
  EVERY row simultaneously; matching rows are sampled into the TAG
  register,
* ``write(cols, bits)``   — parallel write into the unmasked columns of
  all tagged rows (compare+write pairs execute in the same cycle, §2.2),
* ``move(direction, step)`` — shift the TAG vector by ``short_step`` (1)
  or ``long_step`` (16) positions (Fig. 1(c)),
* ``if_match``            — global OR of the TAG vector.

Cycle accounting follows the paper: a compare immediately followed by a
dependent parallel write counts as ONE cycle (simultaneous execution,
§2.2); standalone compares, writes and each tag move count one cycle
each.  The controller is SIMD: every op sequence is data-independent, so
cycle counts are closed-form functions of the operand widths
(`aida_sim.py` reproduces them and the tests assert equality).

Every primitive runs as a few tensor ops over all rows and leaves its
result on the device: the count of tagged rows a write charges to
``write_bitcells`` accumulates there and is read when ``counters`` is,
and ``if_match`` is the only primitive that waits for the device.
Column and key sequences given as host values are copied to the device
once per AP and reused.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device

SHORT_STEP = 1
LONG_STEP = 16  # Fig. 1(c)

Bits = Union[Sequence[int], np.ndarray, torch.Tensor]


@dataclasses.dataclass
class Field:
    """A named bit-column range [base, base+width); LSB first."""
    base: int
    width: int

    def cols(self, lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
        hi = self.width if hi is None else hi
        if not 0 <= lo <= hi <= self.width:
            raise ValueError(f"columns [{lo}, {hi}) outside width "
                             f"{self.width}")
        return np.arange(self.base + lo, self.base + hi)

    def col(self, i: int) -> int:
        if not 0 <= i < self.width:
            raise ValueError(f"column {i} outside width {self.width}")
        return self.base + i


class AP:
    """The CAM array + TAG logic + op/energy counters."""

    def __init__(self, rows: int, bits: int, device=None):
        self.rows = rows
        self.bits = bits
        self.device = resolve_device(device)
        self.cam = torch.zeros((bits, rows), dtype=torch.uint8,
                               device=self.device)
        self.tag = torch.zeros(rows, dtype=torch.bool, device=self.device)
        self._all = torch.ones(rows, dtype=torch.bool, device=self.device)
        # tagged rows when the host knows them (after an empty-mask
        # compare); None: only the device knows
        self._n_tagged: Optional[int] = 0
        self._counters: Dict[str, int] = dict(
            cycles=0, compare=0, write=0, move=0, if_match=0,
            compare_bitcells=0, write_bitcells=0, tag_events=0)
        self._write_bitcells = torch.zeros((), dtype=torch.int64,
                                           device=self.device)
        self._consts: Dict[tuple, torch.Tensor] = {}

    @property
    def counters(self) -> Dict[str, int]:
        """The eight counters (reading them waits for the device)."""
        c = dict(self._counters)
        c["write_bitcells"] += int(self._write_bitcells)
        return c

    def _const(self, seq: Bits, dtype) -> torch.Tensor:
        """``seq`` as a device tensor: a tensor passes through, host values
        are copied once per AP."""
        if isinstance(seq, torch.Tensor):
            return seq
        key = (dtype, tuple(int(v) for v in np.ravel(seq)))
        t = self._consts.get(key)
        if t is None:
            t = torch.tensor(key[1], dtype=dtype, device=self.device)
            self._consts[key] = t
        return t

    # ------------------------------------------------------------------ ops
    def compare(self, cols: Bits, key: Bits,
                fuse_write: bool = False) -> torch.Tensor:
        """Match ``key`` against columns ``cols`` of every row → TAG.

        ``fuse_write=True`` marks this compare as the first half of a fused
        compare+write pair; the cycle is charged by the write.
        """
        cols = self._const(cols, torch.int64)
        key = self._const(key, torch.uint8)
        if cols.shape != key.shape:
            raise ValueError(f"{cols.numel()} columns, {key.numel()} key bits")
        n = cols.numel()
        if n == 0:
            self.tag, self._n_tagged = self._all, self.rows
        else:
            sel = self.cam.index_select(0, cols)
            self.tag = (sel == key[:, None]).all(0)
            self._n_tagged = None
        self._counters["compare"] += 1
        self._counters["compare_bitcells"] += self.rows * n
        self._counters["tag_events"] += self.rows
        if not fuse_write:
            self._counters["cycles"] += 1
        return self.tag

    def write(self, cols: Bits, bits: Bits, fused: bool = False) -> None:
        """Parallel write of ``bits`` into columns ``cols`` of tagged rows."""
        cols = self._const(cols, torch.int64)
        bits = self._const(bits, torch.uint8)
        if cols.shape != bits.shape:
            raise ValueError(f"{cols.numel()} columns, {bits.numel()} bits")
        n = cols.numel()
        if n:
            if self._n_tagged == self.rows:
                new = bits[:, None].expand(n, self.rows)
            else:
                new = torch.where(self.tag, bits[:, None],
                                  self.cam.index_select(0, cols))
            self.cam.index_copy_(0, cols, new)
        self._counters["write"] += 1
        if self._n_tagged is None:
            self._write_bitcells.add_(self.tag.sum(), alpha=n)
        else:
            self._counters["write_bitcells"] += self._n_tagged * n
        self._counters["cycles"] += 1  # fused pair charged once, here
        del fused

    def compare_write(self, ccols, ckey, wcols, wbits) -> None:
        """Fused compare+write (one cycle, §2.2)."""
        self.compare(ccols, ckey, fuse_write=True)
        self.write(wcols, wbits, fused=True)

    def move(self, direction: str, step: int) -> None:
        """Shift TAG by ``step`` rows; 'up' = toward row 0 (paper Fig. 3)."""
        if step not in (SHORT_STEP, LONG_STEP):
            raise ValueError(f"step {step}: {SHORT_STEP} or {LONG_STEP}")
        t = torch.zeros_like(self.tag)
        keep = self.rows - step
        if direction == "up":
            if keep > 0:
                t[:keep] = self.tag[step:]
        elif direction == "down":
            if keep > 0:
                t[step:] = self.tag[:keep]
        else:
            raise ValueError(direction)
        self.tag, self._n_tagged = t, None
        self._counters["move"] += 1
        self._counters["cycles"] += 1
        self._counters["tag_events"] += self.rows

    def move_by(self, direction: str, dist: int) -> int:
        """Decompose an arbitrary distance into long/short steps (Fig. 1(c)).

        Returns the number of move cycles spent.
        """
        n_long, rem = divmod(dist, LONG_STEP)
        for _ in range(n_long):
            self.move(direction, LONG_STEP)
        for _ in range(rem):
            self.move(direction, SHORT_STEP)
        return n_long + rem

    def if_match(self) -> bool:
        self._counters["if_match"] += 1
        self._counters["cycles"] += 1
        if self._n_tagged is not None:
            return self._n_tagged > 0
        return bool(self.tag.any())

    def set_tag(self, tag) -> None:
        """Load TAG directly.  Not a hardware op and not used by the FC
        driver: kept for parity with the JAX package's AP, so the tests can
        start both emulators from one TAG."""
        self.tag = torch.as_tensor(np.asarray(tag, dtype=bool),
                                   device=self.device).clone()
        self._n_tagged = None

    # ------------------------------------------------------------ host I/O
    def load_fields(self, field: Field, values: torch.Tensor, rows=None,
                    width: Optional[int] = None) -> None:
        """CAM image initialisation (a DMA load, not cycle-counted): the
        low ``width`` bits of int64 ``values`` (two's complement) into
        ``field`` of ``rows`` (default: rows 0 .. len(values) - 1)."""
        width = field.width if width is None else width
        values = torch.as_tensor(values, dtype=torch.int64,
                                 device=self.device)
        rows = slice(0, values.numel()) if rows is None else rows
        shifts = torch.arange(width, device=self.device)
        bits = (values[None, :] >> shifts[:, None]) & 1
        self.cam[field.base: field.base + width, rows] = bits.to(torch.uint8)

    def read_fields(self, field: Field, rows,
                    signed: bool = False) -> torch.Tensor:
        """``field`` of ``rows`` as int64 (two's complement of the field's
        width when ``signed``)."""
        bits = self.cam[field.base: field.base + field.width, rows].long()
        shifts = torch.arange(field.width, device=self.device)
        v = (bits << shifts.view((-1,) + (1,) * (bits.ndim - 1))).sum(0)
        if signed:
            v = torch.where(v >= 1 << (field.width - 1),
                            v - (1 << field.width), v)
        return v

    def image(self) -> np.ndarray:
        """The CAM as the JAX package's emulator holds it: uint8
        ``[rows, bits]`` on the host."""
        return self.cam.T.cpu().numpy()


def move_cycles(dist: int) -> int:
    """Closed-form cycle cost of move_by (for the analytical simulator)."""
    n_long, rem = divmod(dist, LONG_STEP)
    return n_long + rem

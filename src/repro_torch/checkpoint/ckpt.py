"""Async, atomic checkpointing in the JAX package's on-disk format.

Layout:  <dir>/step_<N>/
           manifest.json          step, n_leaves, treedef, extra, shapes,
                                  dtypes
           arr_<idx>.npy          one file per leaf, in the JAX package's
                                  tree-leaf order (NamedTuple fields in
                                  order, dict keys sorted)
           .COMMITTED             written last - restore ignores uncommitted
                                  (partially-written / preempted) checkpoints

The files are those the JAX package writes for the same tree: a bf16
leaf is its raw 2-byte words (``<V2`` in the ``.npy`` header,
``"bfloat16"`` in the manifest), so either package reads the other's
checkpoints.  ``treedef`` is this package's own description of the tree
(the JAX package writes its ``PyTreeDef``); neither side's ``restore``
reads it.

Fault-tolerance contract:
  * atomic: tmp-dir + rename, .COMMITTED marker written last;
  * async: save() copies every leaf to host memory before it returns (the
    training step updates params and moments in place, so the writer must
    never see a live tensor) and writes in a background thread;
  * elastic: restore() reassembles whole tensors onto the device asked
    for, whatever topology wrote them;
  * retention: keep_last newest checkpoints survive garbage collection.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: the ``.npy`` descriptor the JAX package's bf16 leaves carry
BF16_DESCR = "<V2"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> List[Any]:
    """The leaves of ``tree`` in the JAX package's order: NamedTuple and
    sequence items in order, dict values by sorted key, None skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in flatten(item)]
    return [tree]


def unflatten(template, leaves) -> Any:
    """``template``'s structure with its leaves taken from ``leaves``."""
    it = iter(leaves)

    def fill(t):
        if t is None:
            return None
        if isinstance(t, dict):
            done = {k: fill(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(fill(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(fill(x) for x in t)
        return next(it)
    out = fill(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def treedef(tree) -> str:
    """A description of ``tree``'s structure (this package's counterpart
    of the JAX package's ``str(PyTreeDef)``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{f}={treedef(x)}" for f, x in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(treedef(x) for x in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _host_copy(x):
    """A host copy of one leaf that nothing else holds: a tensor is copied
    off its device (or cloned on the CPU), an array copied."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


def _numpy(x) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype) of a host leaf; a bf16 tensor
    becomes its 16-bit words."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    return x, str(x.dtype)


def _save_npy(path: str, a: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, a)
        return
    a = np.require(a, requirements="C")      # keeps a 0-d leaf 0-d
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": a.shape})
        f.write(a.tobytes())


def _load(path: str, dtype: str) -> torch.Tensor:
    a = np.require(np.load(path), requirements=["C", "W"])
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Copy every leaf of ``tree`` to host memory, then write step
        ``step`` in a background thread (at once with ``blocking``)."""
        host = [_host_copy(x) for x in flatten(tree)]
        self.wait()                                  # one writer at a time
        self._thread = threading.Thread(
            target=self._write, args=(step, host, treedef(tree), extra),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Wait for the writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step, host, treedef_str, extra):
        try:
            self._write_step(step, host, treedef_str, extra)
        except BaseException as e:                   # surfaced by wait()
            self._error = e

    def _write_step(self, step, host, treedef_str, extra):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        arrays = [_numpy(x) for x in host]
        manifest = {"step": step, "n_leaves": len(arrays),
                    "treedef": treedef_str, "extra": extra or {},
                    "shapes": [list(a.shape) for a, _ in arrays],
                    "dtypes": [d for _, d in arrays]}
        for i, (a, d) in enumerate(arrays):
            _save_npy(os.path.join(tmp, f"arr_{i}.npy"), a, d)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, ".COMMITTED"), "w") as f:
            f.write("ok")
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def list_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.dir, name, ".COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> Tuple[Any, Dict]:
        """Restore into ``template``'s tree structure: (tree, extra).  Each
        leaf takes its template leaf's dtype and goes to ``device`` (None:
        where the template leaf lives, the CPU for an array)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no committed checkpoint found")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = flatten(template)
        assert manifest["n_leaves"] == len(leaves), \
            "checkpoint/template structure mismatch"
        out = []             # one leaf at a time in host memory
        for i, (dt, t) in enumerate(zip(manifest["dtypes"], leaves)):
            h = _load(os.path.join(d, f"arr_{i}.npy"), dt)
            assert tuple(h.shape) == tuple(np.shape(t)), \
                f"shape mismatch {tuple(h.shape)} vs {tuple(np.shape(t))}"
            if isinstance(t, torch.Tensor):
                dev = t.device if device is None else device
                out.append(h.to(device=dev, dtype=t.dtype))
            else:
                dtype = torch.from_numpy(np.zeros(0, np.asarray(t).dtype)) \
                    .dtype
                out.append(h.to(device=device or "cpu", dtype=dtype))
        return unflatten(template, out), manifest["extra"]

"""The four built-in execution backends behind the `Executor` protocol.

  torch-dense  decode of raw params or dense CompressedFC leaves; the
               JAX package's ``jax-dense``
  cuda         compressed decode: int8 / codebook4 / acsr / aida leaves run
               through the hand-written CUDA kernels K1 / K4 / K5; the JAX
               package's ``pallas``
  ap-emulator  bit-level CAM emulator of the paper's Fig. 3 algorithm on
               the engine's device (exact outputs AND exact cycle counts)
  cycle-sim    closed-form analytical cost models (aida_sim + eie_sim), on
               the host

`ap-emulator` and `cycle-sim` agree on FC cycle counts by construction:
`cycle-sim` with the EMULATOR microcode reproduces the emulator's counter
exactly.

A serving session takes its step from the engine's active decode backend
(`Session(backend=)`).  Both decoders give `models.model.decode_step`,
where `models.layers.dense` sends a CompressedFC leaf to `apply_fc`:
what the backend decides is which modes a pinned engine accepts.
`run_fc` applies one layer outside a model (the facade's per-layer call,
as in the JAX package).
"""
from __future__ import annotations

import torch

from repro_torch.api.registry import (Capabilities, CapabilityError,
                                      Executor, register_backend)
from repro_torch.api.spec import MODES, WORKLOADS, FCProblem


# --------------------------------------------------------------- decoders
class TorchDenseBackend(Executor):
    """Decode of raw or dense-mode params; ``run_fc`` is the reference's
    plain f32 product ``x @ W.T``."""
    name = "torch-dense"
    caps = Capabilities(batched_decode=True, modes=("dense",))

    def make_decode_step(self, cfg, plan=None):
        """The decode step; ``plan`` (a `shard.ShardingPlan`) serves it
        over a mesh, this rank's share of the params and state."""
        from repro_torch.models import model as M

        def step(params, state, tokens):
            return M.decode_step(cfg, params, state, tokens, plan=plan)
        return step

    def run_fc(self, layer, x):
        if type(layer).__name__ == "CompressedFC":
            if layer.mode not in self.caps.modes:
                raise CapabilityError(
                    f"{self.name!r} only runs modes {self.caps.modes}; "
                    f"got {layer.mode!r} (use 'cuda')")
            w = layer.dense
        else:
            w = layer
        return torch.matmul(x.float(), w.float().T)


class CudaBackend(TorchDenseBackend):
    """Compressed decode: the same decode step, in which CompressedFC
    leaves reach the CUDA kernels (K1 for acsr / aida, K4 for int8, K5 for
    codebook4; their plain versions on CPU tensors); ``run_fc`` is
    `apply_fc` on one leaf."""
    name = "cuda"
    caps = Capabilities(batched_decode=True, per_layer_override=True,
                        modes=MODES)

    def run_fc(self, layer, x):
        from repro_torch.core.sparse_fc import apply_fc
        if type(layer).__name__ != "CompressedFC":
            raise CapabilityError(
                f"{self.name!r}.run_fc expects a CompressedFC layer")
        return apply_fc(layer, x)


# --------------------------------------------------------------- emulator
class APEmulatorBackend(Executor):
    """Bit-level associative-processor emulator (core.aida_fc): runs the
    paper's Fig. 3 FC algorithm op-by-op and measures exact cycles."""
    name = "ap-emulator"
    caps = Capabilities(cycle_accounting=True, modes=("aida",))

    def estimate(self, workload: FCProblem, device=None, **kw) -> dict:
        from repro_torch.core import aida_fc
        if not isinstance(workload, FCProblem):
            raise CapabilityError(
                f"{self.name!r} estimates concrete FCProblem workloads; "
                f"use 'cycle-sim' for named workloads {WORKLOADS}")
        p = workload
        if p.coded:
            res = aida_fc.aida_fc_layer_coded(
                p.w, p.b, p.cents_w, p.cents_a, activation=p.activation,
                device=device)
            ref = aida_fc.fc_reference_coded(p.w, p.b, p.cents_w, p.cents_a,
                                             activation=p.activation)
        else:
            res = aida_fc.aida_fc_layer(p.w, p.b, m=p.m, n=p.n,
                                        activation=p.activation,
                                        device=device)
            ref = aida_fc.fc_reference(p.w, p.b, activation=p.activation)
        ref = torch.from_numpy(ref).to(res.out.device)
        return {"backend": self.name, "cycles": res.cycles,
                "out": res.out, "reference": ref,
                "exact": torch.equal(res.out, ref),
                "rounds": res.rounds, "nnz_b": res.nnz_b,
                "max_row_nnz": res.max_row_nnz,
                "counters": dict(res.counters), "seconds": res.seconds,
                "pus": res.ap.rows, "bits": res.layout.total_bits}


# -------------------------------------------------------------- cost model
class CycleSimBackend(Executor):
    """Closed-form analytical simulators: AIDA (aida_sim) and the EIE
    baseline (eie_sim), on the host (``device`` is not used).  Workloads:
    an FCProblem (per-layer cycle count, EMULATOR microcode by default —
    bit-exact vs 'ap-emulator'), a named network ('alexnet-fc' /
    'ctc-lstm' / 'table1'), or a list of FCLayerSpec (PAPER microcode by
    default)."""
    name = "cycle-sim"
    caps = Capabilities(cycle_accounting=True, modes=("aida",))

    @staticmethod
    def _microcode(mc):
        from repro_torch.core import aida_sim as S
        if mc is None or mc == "paper":
            return S.PAPER
        if mc == "emulator":
            return S.EMULATOR
        return mc  # a Microcode instance

    def estimate(self, workload, device=None, simulator: str = "aida",
                 microcode=None, **kw) -> dict:
        from repro_torch.core import aida_sim as S
        from repro_torch.core import eie_sim as E
        del device
        if isinstance(workload, FCProblem):
            if simulator != "aida":
                raise CapabilityError(
                    f"simulator {simulator!r} cannot price a bit-level "
                    "FCProblem; the EIE model takes FCLayerSpec networks")
            p = workload
            mc = self._microcode(microcode or "emulator")
            ph = S.cycles_fc(p.w.shape[1], p.nnz_b, p.max_row_nnz, mc,
                             mode="coded" if p.coded else "bitserial",
                             m=p.m, n=p.n, prod_bits=p.prod_bits)
            return {"backend": self.name, "simulator": simulator,
                    "cycles": ph.total(mc),
                    "phases": {"broadcast": ph.broadcast,
                               "multiply": ph.multiply,
                               "reduce": ph.reduce, "act": ph.act},
                    "nnz_b": p.nnz_b, "max_row_nnz": p.max_row_nnz}
        mc = self._microcode(microcode)
        if workload == "table1":
            return {"backend": self.name,
                    "aida": S.aida_table1(mc), "eie": E.eie_table1()}
        if isinstance(workload, str):
            if workload not in ("alexnet-fc", "ctc-lstm"):
                raise CapabilityError(
                    f"unknown workload {workload!r}; named workloads: "
                    f"{WORKLOADS}")
            layers = (S.alexnet_fc() if workload == "alexnet-fc"
                      else S.ctc_lstm())
            name = workload
        else:
            layers, name = list(workload), "custom"
        if simulator == "aida":
            rep = S.evaluate_network(name, layers, mc, **kw)
        elif simulator == "eie":
            rep = E.evaluate_network(name, layers, **kw)
        else:
            raise CapabilityError(
                f"unknown simulator {simulator!r}; choose 'aida' or 'eie'")
        return {"backend": self.name, "simulator": simulator,
                "report": rep,
                "cycles": rep.cycles_total,
                "inf_per_s": rep.inf_per_s}


register_backend(TorchDenseBackend())
register_backend(CudaBackend())
register_backend(APEmulatorBackend())
register_backend(CycleSimBackend())

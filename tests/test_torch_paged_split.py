"""The paged-attention kernel's split plan and input check (K2 / K3), on
the CPU: the plan is a function of a row alone, covers every live page of
the row once and in order, matches the CUDA source's constants, and the
wrapper refuses what the kernel does not take before anything is built or
launched."""
import importlib
import inspect
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kvstore.pool import PagedKV, init_pool

# the module (the package exports its function of the same name)
tpa = importlib.import_module("repro_torch.kvstore.paged_attention")
SRC = pathlib.Path(tpa.__file__).resolve().parents[1] / "csrc" / \
    "paged_attention.cu"


def test_split_plan_takes_no_batch_chunk_width_or_sm_count():
    """A row's ranges depend on its own pages and the page size only, so
    its sum order, and bits, never depend on the batch it is in, the
    chunk, the table width or the card."""
    assert list(inspect.signature(tpa.split_plan).parameters) == \
        ["n_pages", "page_size"]


@pytest.mark.parametrize("ctx_lo,ctx_hi", [(1, 2048), (2049, 4096),
                                           (4097, 6144), (6145, 8192)])
@pytest.mark.parametrize("ps", [8, 16, 32])
def test_split_plan_covers_every_live_page_once_in_order(ps, ctx_lo, ctx_hi):
    """For every context: ranges start at key 0, follow one another with
    no gap or overlap, end with the row's last live page, hold
    RANGE_KEYS keys each but the last, and (the page size dividing the
    range) each page lies whole in exactly one range, in page order."""
    for ctx in range(ctx_lo, ctx_hi + 1):
        n = -(-ctx // ps)                     # pages up to key ctx - 1
        plan = tpa.split_plan(n, ps)
        assert plan[0][0] == 0 and plan[-1][1] == n * ps
        pages = []
        for i, (k0, k1) in enumerate(plan):
            assert 0 < k1 - k0 <= tpa.RANGE_KEYS
            if i + 1 < len(plan):
                assert k1 - k0 == tpa.RANGE_KEYS and plan[i + 1][0] == k1
            assert k0 % ps == 0 and k1 % ps == 0
            pages.extend(range(k0 // ps, k1 // ps))
        assert pages == list(range(n))


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_split_plan_is_the_same_in_any_table(ps):
    """The launch sizes its grid from the table width (the most ranges a
    row of that table can have); a row's own ranges are the same keys in
    any table that holds it, a prefix of the wider table's plan."""
    for n in (1, 3, 16, 17, 128, 129, 512):
        own = tpa.split_plan(n, ps)
        for width in (n, n + 1, 2 * n + 5, 1024):
            wide = tpa.split_plan(width, ps)
            assert len(own) <= len(wide)
            assert own[:-1] == wide[:len(own) - 1]
            assert own[-1][0] == wide[len(own) - 1][0]


def test_source_constants_match_the_plan():
    """The CUDA kernel cuts rows with the plan's range and takes the
    wrapper's row limit."""
    text = SRC.read_text()
    assert int(re.search(r"constexpr int RANGE = (\d+);", text).group(1)) \
        == tpa.RANGE_KEYS
    assert int(re.search(r"constexpr int MAX_ROWS = (\d+);", text).group(1)) \
        == tpa.MAX_ROWS


def _operands(dh=128, h=8, hkv=2, c=4, kv_dtype="bf16", q_dtype=None,
              ps=16, npp=5, b=3):
    pool = init_pool(1 + b * npp, hkv, ps, dh, kv_dtype=kv_dtype)
    q = torch.zeros((b, h, c, dh), dtype=q_dtype or torch.bfloat16)
    table = torch.full((b, npp), -1, dtype=torch.int32)
    q_pos = torch.zeros((b, c), dtype=torch.int32)
    return q, pool, table, q_pos


@pytest.mark.parametrize("dh", tpa.HEAD_DIMS)
def test_check_takes_every_multiple_of_16_up_to_256(dh):
    """Every head dim of whole m16n8k16 depth steps: 80 (h2o-danube-1.8b,
    hubert-xlarge) and 96 (phi-3-vision-4.2b) among them."""
    tpa._check(*_operands(dh=dh))


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("h,hkv,c", [(8, 2, 1), (8, 2, 8), (32, 1, 1),
                                     (32, 32, 8)])
def test_check_takes_the_kernels_kinds_and_groups(q_dtype, kv_dtype, h,
                                                  hkv, c):
    tpa._check(*_operands(h=h, hkv=hkv, c=c, kv_dtype=kv_dtype,
                          q_dtype=q_dtype))


def _misaligned(pool: PagedKV) -> PagedKV:
    """The same pages one element past a 16-byte boundary."""
    flat = torch.zeros(pool.k_pages.numel() + 1, dtype=pool.k_pages.dtype)
    k = flat[1:].view(pool.k_pages.shape)
    return PagedKV(k, pool.v_pages, pool.k_scale, pool.v_scale)


@pytest.mark.parametrize("case,err,match", [
    ("dh24", ValueError, "multiple of 16"),
    ("dh272", ValueError, "multiple of 16"),
    ("q_f16", TypeError, "bf16/f32 q"),
    ("pages_f32", TypeError, "bf16/int8"),
    ("v_int8", TypeError, "bf16/int8"),
    ("group33", ValueError, "at most 32"),
    ("ragged_group", ValueError, "must divide"),
    ("table_i64", TypeError, "int32"),
    ("pos_shape", ValueError, "do not match"),
    ("q_strided", ValueError, "contiguous"),
    ("misaligned", ValueError, "16-byte"),
    ("no_scales", TypeError, "scales"),
])
def test_launch_refuses_what_the_kernel_does_not_take(case, err, match,
                                                      monkeypatch):
    """The wrapper's check runs before any library is built or loaded:
    each refused input raises, and nothing is launched."""
    def no_launch(name):
        raise AssertionError("a refused input reached the launch")
    monkeypatch.setattr(build, "library", no_launch)
    q, pool, table, q_pos = _operands()
    if case == "dh24":
        q, pool, table, q_pos = _operands(dh=24)
    elif case == "dh272":
        q, pool, table, q_pos = _operands(dh=272)
    elif case == "q_f16":
        q = q.half()
    elif case == "pages_f32":
        pool = PagedKV(pool.k_pages.float(), pool.v_pages.float())
    elif case == "v_int8":
        pool = PagedKV(pool.k_pages, pool.v_pages.to(torch.int8))
    elif case == "group33":
        q, pool, table, q_pos = _operands(h=66, hkv=2)
    elif case == "ragged_group":
        q, pool, table, q_pos = _operands(h=9, hkv=2)
    elif case == "table_i64":
        table = table.long()
    elif case == "pos_shape":
        q_pos = q_pos[:, :2].contiguous()
    elif case == "q_strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "misaligned":
        pool = _misaligned(pool)
    elif case == "no_scales":           # int8 pages, one scale of two
        pool = PagedKV(pool.k_pages.to(torch.int8),
                       pool.v_pages.to(torch.int8),
                       torch.zeros(pool.k_pages.shape[:2]), None)
    with pytest.raises(err, match=match):
        tpa._launch(q, pool, table, q_pos, -1, 1.0, None)


def test_launch_reaches_the_library_with_what_it_takes(monkeypatch):
    """An input the kernel takes passes the check and goes on to the
    library of the untuned range (stopped here: there is no card, whose
    SM count the tuner's lookup reads, so a card's is given)."""
    def stop(name):
        assert name == "paged_attention"
        raise RuntimeError("stopped at the launch")
    monkeypatch.setattr(build, "library", stop)
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    with pytest.raises(RuntimeError, match="stopped at the launch"):
        tpa._launch(*_operands(dh=80), -1, 1.0, None)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_idle_row_is_the_mean_of_page_zero(kv_dtype):
    """A row with no page (table of -1 only) has no valid key; the
    finite -1e30 mask makes it the mean of page 0's V rows (what it
    visits), never NaN and never 0.  The kernel keeps this: its plan
    visits page 0 for every -1 entry of the row's live pages."""
    rng = np.random.default_rng(4)
    ps, dh, hkv = 8, 32, 2
    k = torch.from_numpy(rng.normal(size=(3, hkv, ps, dh))).float()
    v = torch.from_numpy(rng.normal(size=(3, hkv, ps, dh))).float()
    if kv_dtype == "bf16":
        pool = PagedKV(k.bfloat16(), v.bfloat16())
        v0 = pool.v_pages[0].float()
    else:
        pool = PagedKV(k.mul(20).round().to(torch.int8),
                       v.mul(20).round().to(torch.int8),
                       torch.full((3, hkv), 0.05), torch.full((3, hkv), 0.05))
        v0 = pool.v_pages[0].float() * 0.05
    q = torch.from_numpy(rng.normal(size=(1, 2 * hkv, dh))).bfloat16()
    table = torch.full((1, 4), -1, dtype=torch.int32)
    out = ref.paged_attention_ref(q, *pool, table,
                                  torch.tensor([13], dtype=torch.int32), -1,
                                  dh ** -0.5, None)
    want = v0.mean(dim=1).repeat_interleave(2, dim=0)        # [H, Dh]
    assert torch.isfinite(out).all() and out.abs().max() > 0
    torch.testing.assert_close(out[0], want, rtol=0, atol=1e-6)

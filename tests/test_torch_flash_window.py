"""The flash kernels' sliding window (``window``: key j visible to query i
iff i - window < j <= i), in their plain versions on the CPU, and the card
kernels against the plain versions (``cuda``-marked, skipped without a
card).

- K1's and the backward's plain versions against dense attention with the
  window's mask, forward and backward, in f32 (1e-5 of each tensor's max:
  the same sums in other orders), at D 64 and 128, GQA 8:1, windows that
  do and do not fall on tile edges;
- a window of T or more is causal attention, bit for bit; a window of 1
  reads the diagonal alone (o = v);
- the tile bounds the kernels walk (``_window_first_k_tile``,
  ``_window_last_q_tile``) against a brute-force search over tile pairs;
- ``ring_attention`` and a window outside the causal mask are refused;
- on the card, K1 and the backward at T 8192, W 2048 against the plain
  versions (one q head at a time), and W >= T equal to the causal kernels.
"""

import pytest
import torch

from mpi_operator_tpu_torch.kernels import flash_attention as fa
from mpi_operator_tpu_torch.parallel.ring_attention import ring_attention

TOL = 1e-5


def _inputs(seed, b, t, h, h_kv, d, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    shapes = ((b, h, t, d), (b, h_kv, t, d), (b, h_kv, t, d), (b, h, t, d))
    return tuple(torch.randn(s, generator=g).to(dtype).to(device) for s in shapes)


def _dense(q, k, v, scale, window):
    """Attention with the window's mask over the whole score matrix."""
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    t = q.shape[2]
    i = torch.arange(t)[:, None]
    j = torch.arange(t)[None, :]
    seen = (i >= j) & (i - j < window)
    s = (q @ k.transpose(-1, -2)) * scale
    return torch.softmax(s.masked_fill(~seen, float("-inf")), -1) @ v


def _close(got, want, tol=TOL):
    """Within ``tol`` of want's max, or of 1 where want is all but zero (a
    window of 1 leaves no gradient to q and k)."""
    got, want = got.detach().float(), want.detach().float()
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [1, 37, 128, 129, 200])
def test_plain_window_matches_dense_masked_attention(d, window):
    q, k, v, do = _inputs(window + d, 1, 300, 8, 1, d)  # GQA 8:1
    scale = d ** -0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=True, scale=scale, layout="bhtd", window=window)
    grads = torch.autograd.grad(o, leaves, do)
    dense_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = _dense(*dense_leaves, scale, window)
    want_grads = torch.autograd.grad(want, dense_leaves, do)
    _close(o, want)
    for got, ref in zip(grads, want_grads):
        _close(got, ref)


@pytest.mark.parametrize("window", [300, 301, 4096])
def test_a_window_of_t_or_more_is_causal(window):
    q, k, v, do = _inputs(5, 2, 300, 4, 2, 64)
    scale = 0.125
    o_w, lse_w = fa.flash_fwd_plain(q, k, v, True, scale, window=window)
    o_c, lse_c = fa.flash_fwd_plain(q, k, v, True, scale)
    assert torch.equal(o_w, o_c) and torch.equal(lse_w, lse_c)
    delta = (do * o_c).sum(-1)
    for got, want in zip(fa.flash_bwd_plain(q, k, v, do, lse_c, delta, True, scale, window),
                         fa.flash_bwd_plain(q, k, v, do, lse_c, delta, True, scale)):
        assert torch.equal(got, want)


def test_a_window_of_one_reads_the_diagonal():
    q, k, v, _ = _inputs(6, 1, 200, 4, 4, 64)
    o, lse = fa.flash_fwd_plain(q, k, v, True, 0.125, window=1)
    _close(o, v)
    _close(lse, (q * k).sum(-1) * 0.125)


@pytest.mark.parametrize("t,window", [(1000, 1), (1000, 64), (1000, 127), (1000, 300),
                                      (8192, 2048), (640, 640)])
def test_tile_bounds_are_the_tiles_holding_visible_pairs(t, window):
    """K1 walks k tiles [_window_first_k_tile, causal end) of each q tile of
    128, K3 q tiles [causal start, _window_last_q_tile] of each k tile of
    128 in q tiles of 64: exactly the tiles holding a visible pair."""

    def holds(q0, q1, k0, k1):  # does [q0, q1) x [k0, k1) hold a visible pair?
        return any(max(k0, qi - window + 1) <= min(k1 - 1, qi) for qi in range(q0, q1))

    for qi in range(-(-t // fa.BLOCK_Q)):
        q0 = qi * fa.BLOCK_Q
        first = fa._window_first_k_tile(q0, window, fa.BLOCK_K)
        last = fa._causal_last_k_tile(qi, fa.BLOCK_Q, fa.BLOCK_K)
        want = [ki for ki in range(-(-t // fa.BLOCK_K))
                if holds(q0, min(t, q0 + fa.BLOCK_Q), ki * fa.BLOCK_K, (ki + 1) * fa.BLOCK_K)]
        assert list(range(first, min(last, -(-t // fa.BLOCK_K) - 1) + 1)) == want
    bk, bq = 128, 64  # K3's tiles
    for ki in range(-(-t // bk)):
        k0 = ki * bk
        first = fa._causal_first_q_tile(ki, bq, bk)
        last = min(-(-t // bq) - 1, fa._window_last_q_tile(k0 + bk - 1, window, bq))
        want = [qi for qi in range(-(-t // bq))
                if holds(qi * bq, min(t, (qi + 1) * bq), k0, min(t, k0 + bk))]
        assert list(range(first, last + 1)) == want


def test_a_window_off_the_causal_mask_and_the_ring_refuse():
    q, k, v, _ = _inputs(7, 1, 64, 2, 2, 64)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, causal=False, window=8, layout="bhtd")
    with pytest.raises(ValueError, match="window"):
        fa.flash_fwd_plain(q, k, v, True, 0.125, window=-1)
    with pytest.raises(ValueError, match="window"):
        ring_attention(q, k, v, None, causal=True, layout="bhtd", window=8)


# -- on the card --------------------------------------------------------------

CARD_SHAPE = (1, 8192, 32, 4, 128)  # B, T, H, Hkv, D: one row of the Trinity cell's attention
CARD_WINDOW = 2048
TOL_O, TOL_GRAD_REL, TOL_ROW = 3e-2, 3e-2, 1e-2  # chip_smoke.py's ceilings and row bound


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")


def _row_err(got, ref):
    g = got.float().reshape(-1, got.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    floor = 0.1 * float(r.pow(2).mean().sqrt())
    return float(((g - r).pow(2).mean(-1).sqrt() / r.pow(2).mean(-1).sqrt().clamp_min(floor)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_card_window_matches_the_plain_versions(card, d):
    b, t, h, h_kv, _ = CARD_SHAPE
    q, k, v, do = _inputs(11, b, t, h, h_kv, d, torch.bfloat16, "cuda")
    scale = d ** -0.5
    o, lse = fa.flash_fwd_cuda(q, k, v, True, scale, CARD_WINDOW)
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = fa.flash_bwd_cuda(q, k, v, do, lse, delta, True, scale, CARD_WINDOW)
    torch.cuda.synchronize()
    g = h // h_kv
    dk_ref = torch.zeros(k.shape, device="cuda")
    dv_ref = torch.zeros(v.shape, device="cuda")
    for i in range(h):
        sl = slice(i, i + 1)
        kv = slice(i // g, i // g + 1)
        o_r, lse_r = fa.flash_fwd_plain(q[:, sl], k[:, kv], v[:, kv], True, scale,
                                        window=CARD_WINDOW)
        assert float((o[:, sl].float() - o_r.float()).abs().max()) <= TOL_O
        assert float((lse[:, sl] - lse_r).abs().max()) <= 1e-3
        dq_r, dk_r, dv_r = fa.flash_bwd_plain(q[:, sl], k[:, kv], v[:, kv], do[:, sl],
                                              lse[:, sl], delta[:, sl], True, scale, CARD_WINDOW)
        assert _row_err(dq[:, sl], dq_r) <= TOL_ROW
        dk_ref[:, kv] += dk_r.float()
        dv_ref[:, kv] += dv_r.float()
    for got, ref in ((dk, dk_ref), (dv, dv_ref)):
        assert float((got.float() - ref).abs().max()) <= TOL_GRAD_REL * float(ref.abs().max())
        assert _row_err(got, ref) <= TOL_ROW


@pytest.mark.cuda
def test_card_window_of_t_or_more_equals_causal(card):
    b, t, h, h_kv, d = CARD_SHAPE
    q, k, v, do = _inputs(12, b, t, h, h_kv, d, torch.bfloat16, "cuda")
    scale = d ** -0.5
    o_c, lse_c = fa.flash_fwd_cuda(q, k, v, True, scale)
    o_w, lse_w = fa.flash_fwd_cuda(q, k, v, True, scale, t)
    assert torch.equal(o_c, o_w) and torch.equal(lse_c, lse_w)
    delta = (do.float() * o_c.float()).sum(-1)
    acc_c = torch.zeros(q.shape, device="cuda")
    acc_w = torch.zeros(q.shape, device="cuda")
    dk_c, dv_c = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_c, delta, acc_c, True, scale)
    dk_w, dv_w = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_c, delta, acc_w, True, scale, t)
    torch.cuda.synchronize()
    assert torch.equal(dk_c, dk_w) and torch.equal(dv_c, dv_w)
    # dq's f32 sums are added in no fixed order: within a few f32 roundings
    assert float((acc_c - acc_w).abs().max()) <= 1e-5 * float(acc_c.abs().max())

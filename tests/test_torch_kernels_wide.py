"""K14 and K1 at the widest shapes the JAX kernels take, on the card.

The whole-stack megacall K14 at 80 layers of the 70B width (d 8192, 64 / 8
heads of 128, d_ff 28,672), where its plan reads the layers' pointer table
from global memory (ops/decode_plan.stack_plan), and K1 on rows whose 8-row
tile of whole rows leaves no slot (Q8_0 at k 28,672, a 70B w_down; Q4_0 at
k 51,072), which run its K-split form (ops/qmatmul.i8_plan, kc > 1), and K5
(the greedy head) on that form.

Every test needs a CUDA device and skips without one; the file imports
neither jax nor zgml_tpu:

    python -m pytest --noconftest -q tests/test_torch_kernels_wide.py

Bounds: K14 holds 1e-5 * max|out| once per layer against its plain version
(tests/test_torch_kernels.py, MEGA_REL_PER_LAYER), equals the per-layer
chain K7 + K6d bit for bit, and two launches give the same bits. K1 holds
1e-5 * max|out| against its plain version (only the f32 sum over blocks
differs), two launches give the same bits, and its own int8 activations
equal the plain pre-pass's. K5 on the K-split plan gives argmax of K1's
split output exactly, the same id over two launches.
"""
import pytest
import torch

from zgml_tpu_torch.ops import refs
from zgml_tpu_torch.ops.qmatmul import (greedy_cuda, i8_plan, qmatmul_i8_cuda, qmatmul_i8_ref,
                                        quantize_act_ref)
from zgml_tpu_torch.quant.packed import PackedWeight

pytestmark = pytest.mark.gpu

MEGA_REL_PER_LAYER = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _weight(g, n, k, device, kind="q4_0"):
    """A random PackedWeight drawn on the card (torch generator g): at 70B
    widths numpy draws take longer than the kernels."""
    d = (torch.rand((n, k // 32), generator=g, device=device) * 0.019 + 0.001).to(torch.float16)
    if kind == "q8_0":                      # int8 levels; Q4_0: any byte is two nibbles
        q = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
        return PackedWeight(n, k, q, d / 16, "q8_0")
    qs = torch.randint(0, 256, (n, k // 2), generator=g, device=device, dtype=torch.uint8)
    return PackedWeight(n, k, qs, d, "q4_0")


# (L, d, hq, hkv, hd, f, S, pos): 80 layers of the 70B width
STACK_70B = (80, 8192, 64, 8, 128, 28672, 2048, 1500)


def test_stack_decode_at_80_layers_of_the_70b_width(cuda):
    """K14 where the pointer table does not fit beside two stages: its 80 rows
    point at two layers' weights (~1 GB). Against its plain version within
    MEGA_REL_PER_LAYER * 80 * max|out|, bit-equal over two launches and to
    the per-layer chain K7 + K6d (whose plans fit at this width)."""
    from zgml_tpu_torch.ops import decode_plan
    from zgml_tpu_torch.ops.stackkernel import (StackedLayers, layer_chain, stacked_decode_cuda,
                                                stacked_decode_ref)
    n_layers, d, hq, hkv, hd, f, s, pos = STACK_70B
    plan = decode_plan.stack_plan(n_layers, d, hq, hkv, hd, f, s,
                                  torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan.act_bytes == decode_plan.stack_act_bytes(n_layers, d, hq, hkv, hd, f, s,
                                                         plan.grid, table=False)
    g = torch.Generator(device=cuda).manual_seed(70)

    def norm():
        return 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    two = [{"attn_norm": norm(), "ffn_norm": norm(),
            "wqkv": _weight(g, (hq + 2 * hkv) * hd, d, cuda), "wo": _weight(g, d, d, cuda),
            "w_gate_up": _weight(g, 2 * f, d, cuda), "w_down": _weight(g, d, f, cuda)}
           for _ in range(2)]
    stack = StackedLayers([two[li % 2] for li in range(n_layers)], hq, hkv, 1e-5)
    x = torch.randn((1, 1, d), generator=g, device=cuda)
    ck = torch.randn((n_layers, 1, hkv, s, hd), generator=g, device=cuda).to(torch.bfloat16)
    cv = torch.randn((n_layers, 1, hkv, s, hd), generator=g, device=cuda).to(torch.bfloat16)
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=cuda), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    ck1, cv1, ck2, cv2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    got = stacked_decode_cuda(x, stack, ck1, cv1, pos_t, cos, sin)
    again = stacked_decode_cuda(x, stack, ck.clone(), cv.clone(), pos_t, cos, sin)
    chain = layer_chain(x, stack, ck2, cv2, pos_t, cos, sin)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, chain):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b) and torch.equal(a.reshape(c.shape), c)
    assert torch.equal(ck1, ck2) and torch.equal(cv1, cv2)
    del ck2, cv2, chain
    want = stacked_decode_ref(x, stack, ck.clone(), cv.clone(), pos, cos, sin)
    rtol = MEGA_REL_PER_LAYER * n_layers
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=rtol * float(b.abs().max()))


@pytest.mark.parametrize("kind,n,k,m", [("q8_0", 8192, 28672, 1), ("q8_0", 8192, 28672, 32),
                                        ("q8_0", 1000, 27040, 5), ("q4_0", 8192, 51072, 1)])
def test_qmatmul_i8_k_split(cuda, kind, n, k, m):
    """K1's K-split form: within 1e-5 * max|out| of its plain version,
    bit-equal over two launches, its int8 activations the pre-pass's."""
    plan = i8_plan(m, n, k, kind, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan.kc > 1
    g = torch.Generator(device=cuda).manual_seed(m + k)
    w = _weight(g, n, k, cuda, kind)
    x = torch.randn((m, k), generator=g, device=cuda)
    x[0, :32] = 0.0                         # an all-zero block: s = 0
    xq = torch.empty((m, k), dtype=torch.int8, device=cuda)
    xs = torch.empty((m, k // 32), dtype=torch.float32, device=cuda)
    y = qmatmul_i8_cuda(x, w, act_out=(xq, xs))
    y2 = qmatmul_i8_cuda(x, w)
    want = qmatmul_i8_ref(x, w)
    xq_r, xs_r = quantize_act_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    assert torch.equal(xq, xq_r) and torch.equal(xs, xs_r)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("kind,n,k", [("q8_0", 8192, 28672), ("q4_0", 8192, 51072),
                                      ("q8_0", 1000, 27040)])
def test_greedy_k_split(cuda, kind, n, k):
    """K5 on K1's K-split plan: its id is argmax of K1's split output on the
    same row (first index on ties) exactly, and the same over two launches;
    a row whose best value sits in two places takes the first."""
    plan = i8_plan(1, n, k, kind, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan.kc > 1
    g = torch.Generator(device=cuda).manual_seed(n + k)
    w = _weight(g, n, k, cuda, kind)
    x = torch.randn((1, k), generator=g, device=cuda)
    y = qmatmul_i8_cuda(x, w)
    ids = [greedy_cuda(x, w), greedy_cuda(x, w)]
    torch.cuda.synchronize()
    assert int(ids[0]) == int(ids[1]) == int(torch.argmax(y[0]))
    # a tie: row n - 1 a copy of the best row, which comes first
    best = int(ids[0])
    qs, d = w.qs.clone(), w.d.clone()
    qs[n - 1], d[n - 1] = qs[best], d[best]
    w2 = PackedWeight(n, k, qs, d, kind)
    y2 = qmatmul_i8_cuda(x, w2)
    tok = greedy_cuda(x, w2)
    torch.cuda.synchronize()
    assert int(tok) == int(torch.argmax(y2[0])) == best

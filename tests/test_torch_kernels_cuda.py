"""Card-only: each hand-written kernel against its plain version, on the card,
at the serving path's shapes. Skipped where there is no CUDA card (the CUDA
kernels have no CPU mode). On a card machine, which has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances, as max |kernel - plain| / max |plain|: 1e-5 in fp32 (sums in
another order); 2e-2 in bf16 (a few bf16 roundings of 2^-8 taken at other
points; the plain version rounds where PyTorch's bf16 ops do); 1e-2 for the
w8 products, whose one bf16 rounding may fall on the other side of a
boundary when the fp32 sum is taken in another order (2^-8 of a value).
The adaLN and q/k norm kernels, and the DiT GEMM's gated residual through
an identity weight (where the product is exact), are also held bit for bit:
at most 1e-4 of elements may differ. A difference starts as one flipped
rounding (fp32 sums in another order, the card's rsqrt and tanh in the
plain version) and grows by the ops after it: one bf16 ulp for the
residual, two of n * (1 + scale) for the adaLN (a flip of n scaled by up to
2), three of the larger value of a RoPE pair for the q/k norm, four for
SwiGLU (both factors).
"""

import math

import pytest
import torch

from smalltts_tpu_torch.ops import kernels
from smalltts_tpu_torch.ops.kernels import attention as A
from smalltts_tpu_torch.ops.kernels import dit_block as K
from smalltts_tpu_torch.ops.kernels import w8 as W
from smalltts_tpu_torch.ops.rope import interleaved_cos_sin

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
W8_TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def randn(shape, g, dev, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)


def key_mask(B, S, g, dev):
    lens = torch.randint(1, S + 1, (B,), generator=g, device=dev)
    m = torch.arange(S, device=dev)[None] < lens[:, None]
    m[-1] = False  # a fully-masked row
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,D", [(8, 8, 256, 64), (8, 4, 384, 128), (2, 8, 40, 120)])
def test_attention_kernel(dev, dtype, B, H, T, D):
    g = gen(dev, D)
    q, k, v = (randn((B, H, T, D), g, dev, dtype) for _ in range(3))
    m = key_mask(B, T, g, dev)
    n0 = kernels.LAUNCHES.get("attention", 0)
    got = A.fused_attention(q, k, v, m)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention"] == n0 + 1
    assert rel(got, A.attention_plain(q, k, v, m)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_two_sources_gate(dev, dtype):
    B, H, T, Sc, D = 8, 8, 40, 192, 120
    g = gen(dev, 1)
    qkvg = randn((B, T, 4 * H * D), g, dev, dtype)
    view = lambda i: qkvg[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D)).transpose(1, 2)  # noqa: E731
    k2, v2 = (randn((B, H, Sc, D), g, dev, dtype) for _ in range(2))
    m1, m2 = key_mask(B, T, g, dev), key_mask(B, Sc, g, dev)
    out = torch.empty((B, T, H * D), device=dev, dtype=dtype)
    A.fused_attention(view(0), view(1), view(2), m1, k2, v2, m2, gate=view(3),
                      out=out.unflatten(-1, (H, D)).transpose(1, 2))
    want = A.attention_plain(view(0), view(1), view(2), m1, k2, v2, m2, gate=view(3))
    assert rel(out.unflatten(-1, (H, D)).transpose(1, 2), want) <= TOL[dtype]


# every fp32 shape the trainers launch (the 3xTF32 kernel): the teacher step's at batch 2 (the DiT's
# 256 self keys and 262 ref + text keys as one source), the distiller's backbone at the teacher's CFG
# batch of 6, the discriminator's at batch 4 and 2; 198, 518 and 1030 keys are no multiple of the
# 32-key tile
FP32_TRAIN = {"teacher-dit": (2, 8, 256, 518, 120), "teacher-text": (2, 4, 198, 198, 128),
              "teacher-style": (2, 8, 64, 64, 64), "distill-dit-B6": (6, 8, 256, 518, 120),
              "distill-text-B6": (6, 4, 198, 198, 128), "distill-style-B6": (6, 8, 64, 64, 64),
              "disc-B4": (4, 8, 1030, 1030, 64), "disc-B2": (2, 8, 1030, 1030, 64)}
FP32_TILE = 32  # keys per tile of the fp32 kernel (csrc/attention.cu, TBK)


@pytest.mark.parametrize("shape", list(FP32_TRAIN))
def test_fp32_attention_at_the_training_shapes(dev, shape):
    """The 3xTF32 kernel against attention_plain within 1e-5 of the largest
    value, one launch a call, a fully-masked row (a uniform average) in each."""
    B, H, T, S, D = FP32_TRAIN[shape]
    g = gen(dev, 300 + S)
    q, k, v = randn((B, H, T, D), g, dev), randn((B, H, S, D), g, dev), randn((B, H, S, D), g, dev)
    m = key_mask(B, S, g, dev)
    kernels.reset_launches()
    got = A.fused_attention(q, k, v, m)
    torch.cuda.synchronize()
    assert kernels.SHAPE_LAUNCHES == {("attention", (B, H, T, S, D, torch.float32)): 1}
    want = A.attention_plain(q, k, v, m)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert rel(got, want) <= TOL[torch.float32]
    assert torch.allclose(got[-1], v[-1].mean(1, keepdim=True).expand_as(got[-1]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,Tq,S2", [(8, 16, 60), (8, 40, 150), (8, 40, 448), (4, 16, 420), (2, 70, 101)])
def test_fp32_attention_split_merge_views(dev, B, Tq, S2):
    """The fp32 kernel where it splits the keys across a cluster (few (b, h,
    q tile) blocks), over two sources with the gate, q/k/v/gate as strided
    views of one (B, T, 4 * H * D) buffer and the result written into a
    strided (B, T, H*D) view, as the DiT lays them out: the second source's
    second 32-key tile masked in every row, batch row 1 with keys only in
    the second source, the last row none."""
    H, D = 8, 120
    g = gen(dev, 400 + S2)
    qkvg = randn((B, Tq, 4 * H * D), g, dev)
    view = lambda i: qkvg[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D)).transpose(1, 2)  # noqa: E731
    k2, v2 = randn((B, H, S2, D), g, dev), randn((B, H, S2, D), g, dev)
    m1, m2 = key_mask(B, Tq, g, dev), key_mask(B, S2, g, dev)
    m1[1] = False
    m2[1, :9] = True
    m2[:, FP32_TILE:2 * FP32_TILE] = False
    m2[-1] = False
    buf = torch.zeros((B, Tq, H * D), device=dev)
    out = buf.unflatten(-1, (H, D)).transpose(1, 2)
    A.fused_attention(view(0), view(1), view(2), m1, k2, v2, m2, gate=view(3), out=out)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(buf).all())
    assert rel(out, A.attention_plain(view(0), view(1), view(2), m1, k2, v2, m2, gate=view(3))) <= TOL[torch.float32]


def test_fp32_attention_rejects_misaligned_views(dev):
    """The 3xTF32 kernel copies and stores rows in 16-byte chunks: a q, k,
    v, gate or out view whose rows are not 16-byte aligned raises (no
    fallback), as bf16 does."""
    B, H, T, D = 2, 2, 8, 64
    base = torch.zeros((B, H, T, D + 1), device=dev)
    bad_stride = base[..., :D]            # rows D + 1 floats apart
    bad_ptr = base.flatten()[1:1 + B * H * T * D].view(B, H, T, D)  # rows start 4 bytes off
    ok = torch.zeros((B, H, T, D), device=dev)
    m = torch.ones((B, T), dtype=torch.bool, device=dev)
    for bad in (bad_stride, bad_ptr):
        for args, kw in (((bad, ok, ok, m), {}), ((ok, bad, ok, m), {}), ((ok, ok, bad, m), {}),
                         ((ok, ok, ok, m), {"gate": bad}), ((ok, ok, ok, m), {"out": bad})):
            with pytest.raises(ValueError, match="16-byte aligned"):
                A.fused_attention(*args, **kw)
    A.fused_attention(ok, ok, ok, m)  # aligned: runs


def adaln_inputs(g, dev, B, T, K_):
    """x (B, T, K_) bf16 ~ N(0, 4), and a modulation's shift and scale (B,
    K_) rows at a batch stride of 6 K_, as the scan slices them."""
    mod = randn((B, 6 * K_), g, dev, torch.bfloat16, 0.5)
    return randn((B, T, K_), g, dev, torch.bfloat16, 2.0), mod[:, :K_], mod[:, K_:2 * K_]


def qk_tables(g, dev, heads, D, T, rot):
    """RMSNorm scales of q and k (heads, D) bf16 near 1, RoPE tables (T, rot) fp32."""
    qs, ks = (1 + randn((heads, D), g, dev, torch.float32, 0.2) for _ in range(2))
    cos, sin = interleaved_cos_sin(T, rot, dev)
    return qs.to(torch.bfloat16), ks.to(torch.bfloat16), cos, sin


@pytest.mark.parametrize("K_,N", [(960, 3840), (960, 4800), (960, 960), (2400, 960)])
def test_gemm_kernels(dev, K_, N):
    B, T = 8, 40
    g = gen(dev, N + K_)
    a = randn((B, T, K_), g, dev, torch.bfloat16)
    w = randn((K_, N), g, dev, torch.bfloat16, 1 / math.sqrt(K_))
    b = randn((N,), g, dev, torch.bfloat16, 0.1)
    if N == 4800:
        assert rel(K.gemm_swiglu(a, w, b), K.gemm_swiglu_plain(a, w, b)) <= 2e-2
        return
    assert rel(K.gemm_bias(a, w, b), K.gemm_bias_plain(a, w, b)) <= 2e-2
    x = randn((B, T, N), g, dev, torch.bfloat16)
    gate = randn((B, N), g, dev, torch.bfloat16)
    mask = key_mask(B, T, g, dev)
    want = K.gemm_residual_plain(a, w, b, x.clone(), gate, mask)
    got = K.gemm_residual(a, w, b, x.clone(), gate, mask)
    assert rel(got, want) <= 2e-2


def test_gemm_ragged_rows(dev):
    """M = 8 * 15 rows is not a multiple of the 64-row tile."""
    g = gen(dev, 7)
    a = randn((8, 15, 960), g, dev, torch.bfloat16)
    w = randn((960, 3840), g, dev, torch.bfloat16, 0.03)
    b = randn((3840,), g, dev, torch.bfloat16)
    assert rel(K.gemm_bias(a, w, b), K.gemm_bias_plain(a, w, b)) <= 2e-2


W8_ROWS = (1, 8, 9, 16, 40, 64, 65, 200, 320)  # around the 8-, 32- and 64-row tiles of the tensor-core kernel
W8_KN = ((960, 2880), (2400, 960), (960, 5760), (96, 136), (200, 144))  # N = 136: no TMA, the streaming kernel


@pytest.mark.parametrize("M,K_,N,L", [(4, 960, 5760, 12), (5, 96, 136, 2), (5, 96, 144, 3)]
                         + [(M, K_, N, 1) for K_, N in W8_KN for M in W8_ROWS])
def test_w8_kernels(dev, M, K_, N, L):
    """All layers (L > 1) or one (K, N) weight, every int8 value in it: rows
    past a row tile, K past a 64-k tile, ragged 128-column tiles, K split over
    a cluster where the tiles are few. The call launches its kernel, and two
    calls give the same bits (the K ranks are merged in rank order)."""
    g = gen(dev, M + N)
    x = randn((M, K_), g, dev, torch.bfloat16)
    w_q = torch.randint(-128, 128, (L, K_, N), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
    scale = 0.001 + 0.01 * torch.rand((L, N), generator=g, device=dev)
    name = "w8_matmul" if L == 1 else "w8_matmul_all_layers"
    run = (lambda: W.w8_matmul(x, w_q[0], scale[0])) if L == 1 else (lambda: W.w8_matmul_all_layers(x, w_q, scale))
    want = W.w8_matmul_ref(x, w_q[0], scale[0]) if L == 1 else W.w8_matmul_ref(x, w_q, scale)
    n0 = kernels.LAUNCHES.get(name, 0)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 2
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert rel(got, want) <= W8_TOL
    assert torch.equal(got, again)


def test_w8_quantized_weights(dev):
    """On weights as `quantize_w8` makes them, at the JAX package's shapes."""
    g = gen(dev, 17)
    for M, K_, N in ((320, 960, 2880), (40, 2400, 960), (8, 960, 5760)):
        x = randn((M, K_), g, dev, torch.bfloat16)
        w_q, scale = W.quantize_w8(randn((K_, N), g, dev, torch.float32, 0.02))
        assert rel(W.w8_matmul(x, w_q, scale), W.w8_matmul_ref(x, w_q, scale)) <= W8_TOL


@pytest.mark.parametrize("N", [136, 144])
def test_w8_view_that_tma_cannot_read(dev, N):
    """A weight view 8 but not 16 bytes into its buffer runs on the streaming
    kernel: it neither raises nor goes to the plain version."""
    g = gen(dev, N)
    M, K_ = 9, 200
    x = randn((M, K_), g, dev, torch.bfloat16)
    buf = torch.randint(-128, 128, (K_ * N + 8,), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
    w_q = buf[8:].view(K_, N)
    assert w_q.data_ptr() % 16 == 8 and w_q.is_contiguous()
    scale = 0.001 + 0.01 * torch.rand((N,), generator=g, device=dev)
    n0 = kernels.LAUNCHES.get("w8_matmul", 0)
    got = W.w8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["w8_matmul"] == n0 + 1
    assert rel(got, W.w8_matmul_ref(x, w_q, scale)) <= W8_TOL
    assert torch.equal(got, W.w8_matmul(x, w_q, scale))


@pytest.mark.parametrize("M", [8, 320])
def test_w8_stacked_reads_a_device_index_without_a_sync(dev, M):
    """The layer index stays on the card: PyTorch raises on any
    synchronizing call in "error" sync-debug mode. An index outside the
    stack is clamped."""
    g = gen(dev, 13)
    x = randn((M, 960), g, dev, torch.bfloat16)
    w_q, scale = W.quantize_w8(randn((12, 960, 3840), g, dev, torch.float32, 0.02))
    layers = (0, 5, 11, 40, -2)
    idxs = [torch.tensor([i], dtype=torch.int32, device=dev) for i in layers]
    W.w8_matmul_stacked(x, w_q, scale, idxs[0])  # builds the kernel
    torch.cuda.synchronize()
    n0 = kernels.LAUNCHES["w8_matmul_stacked"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [W.w8_matmul_stacked(x, w_q, scale, i) for i in idxs]
        got.append(W.w8_matmul_stacked(x, w_q, scale, 7))  # a Python int becomes a fill on the card
        again = W.w8_matmul_stacked(x, w_q, scale, idxs[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.LAUNCHES["w8_matmul_stacked"] == n0 + len(layers) + 2
    for out, i in zip(got, layers + (7,)):
        i = min(max(i, 0), 11)
        assert rel(out, W.w8_matmul_ref(x, w_q[i], scale[i])) <= W8_TOL
    assert torch.equal(again, got[1])


@pytest.mark.parametrize("K_,N", [(960, 3840), (960, 4800), (960, 960), (2400, 960)])
def test_int8_gemm_kernels(dev, K_, N):
    """The int8-weight GEMM, each epilogue, against its plain version: the
    weight dequantized as bf16(bf16(q) * bf16(scale)) before the product."""
    B, T = 8, 40
    g = gen(dev, 3 * N + K_)
    a = randn((B, T, K_), g, dev, torch.bfloat16)
    w_q, scale = W.quantize_w8(randn((K_, N), g, dev, torch.float32, 1 / math.sqrt(K_)))
    scale = scale[None]  # (1, N), as a layer of the (L, 1, N) stream scales
    b = randn((N,), g, dev, torch.bfloat16, 0.1)
    if N == 4800:
        n0 = kernels.LAUNCHES.get("gemm_swiglu_w8", 0)
        got = K.gemm_swiglu(a, w_q, b, w_scale=scale)
        assert kernels.LAUNCHES["gemm_swiglu_w8"] == n0 + 1
        assert rel(got, K.gemm_swiglu_plain(a, w_q, b, w_scale=scale)) <= 2e-2
        return
    assert rel(K.gemm_bias(a, w_q, b, w_scale=scale), K.gemm_bias_plain(a, w_q, b, w_scale=scale)) <= 2e-2
    x = randn((B, T, N), g, dev, torch.bfloat16)
    gate = randn((B, N), g, dev, torch.bfloat16)
    mask = key_mask(B, T, g, dev)
    want = K.gemm_residual_plain(a, w_q, b, x.clone(), gate, mask, w_scale=scale)
    got = K.gemm_residual(a, w_q, b, x.clone(), gate, mask, w_scale=scale)
    assert rel(got, want) <= 2e-2


def test_w8_wrappers_reject_fp32_on_the_card(dev):
    w_q, scale = W.quantize_w8(torch.randn((2, 64, 32), device=dev))
    x = torch.zeros((4, 64), device=dev)
    for call in (lambda: W.w8_matmul(x, w_q[0], scale[0]), lambda: W.w8_matmul_all_layers(x, w_q, scale),
                 lambda: W.w8_matmul_stacked(x, w_q, scale, 1),
                 lambda: K.gemm_bias(x[None], w_q[0], torch.zeros(32, device=dev), w_scale=scale[0])):
        with pytest.raises(ValueError, match="bf16"):
            call()


def test_int8_gemm_rejects_a_misaligned_weight(dev):
    """The int8 tile is copied 16 bytes at a time: a weight view that does not
    start on a 16-byte boundary is refused before the launch, and the card
    stays usable."""
    a = torch.zeros((2, 8, 64), device=dev, dtype=torch.bfloat16)
    flat = torch.zeros((64 * 64 + 16,), device=dev, dtype=torch.int8)
    scale, b = torch.ones((64,), device=dev), torch.zeros((64,), device=dev, dtype=torch.bfloat16)
    for off in (1, 8):
        w_q = flat[off:off + 64 * 64].view(64, 64)
        with pytest.raises(ValueError, match="aligned"):
            K.gemm_bias(a, w_q, b, w_scale=scale)
    got = K.gemm_bias(a, flat[16:].view(64, 64), b, w_scale=scale)
    torch.cuda.synchronize()
    assert float(got.abs().max()) == 0.0


def test_gemm_rejects_fp32_on_the_card(dev):
    a = torch.zeros((2, 8, 64), device=dev)
    with pytest.raises(ValueError):
        K.gemm_bias(a, torch.zeros((64, 64), device=dev), torch.zeros((64,), device=dev))


def test_norm_kernels_reject_fp32_on_the_card(dev):
    x = torch.zeros((2, 8, 64), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        K.adaln_modulate(x, torch.zeros((2, 64), device=dev), torch.zeros((2, 64), device=dev))
    qkvg = torch.zeros((2, 8, 4 * 64), device=dev)
    cos = torch.zeros((8, 16), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        K.qk_norm_rope(qkvg, torch.ones((1, 64), device=dev), torch.ones((1, 64), device=dev), cos, cos)


def test_qk_norm_rope_rejects_a_misaligned_scale(dev):
    """The kernel loads the norm scales, the RoPE tables and the head 16
    bytes at a time: a scale view at an odd element offset (which
    .contiguous() leaves where it is) is refused by the wrapper and by the C
    entry, and the card stays usable."""
    g = gen(dev, 5)
    heads, D, T = 2, 64, 8
    qkvg = randn((2, T, 4 * heads * D), g, dev, torch.bfloat16)
    qs, ks, cos, sin = qk_tables(g, dev, heads, D, T, 16)
    flat = torch.ones((heads * D + 1,), device=dev, dtype=torch.bfloat16)
    odd = flat[1:].view(heads, D)
    with pytest.raises(ValueError, match="aligned"):
        K.qk_norm_rope(qkvg.clone(), odd, ks, cos, sin)
    lib = kernels.load("dit_block")
    status = lib.st_qk_norm_rope(qkvg.data_ptr(), 4 * heads * D, 2 * T, T, heads, D, 16, odd.data_ptr(),
                                 ks.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    assert status != 0
    want = K.qk_norm_rope_plain(qkvg.clone(), qs, ks, cos, sin)
    got = K.qk_norm_rope(qkvg.clone(), qs, ks, cos, sin)
    torch.cuda.synchronize()
    assert rel(got, want) <= 2e-2


def test_linear_bf16_on_the_card_rounds_once(dev):
    """cuBLAS with an fp32 result, then the fp32 bias, then one rounding:
    the same as the upcast product on the card up to the order of the fp32
    sums. Tolerance: 1 bf16 ulp (2^-7 relative) plus 1e-4 absolute, which
    covers fp32 sums in another order (~5e-6 here) where the bias cancels
    the product; at most 1% of entries differ."""
    from smalltts_tpu_torch.ops import nn

    g = gen(dev, 11)
    x = randn((8, 384, 512), g, dev, torch.bfloat16)
    p = {"w": randn((512, 960), g, dev, torch.bfloat16, 0.05), "b": randn((960,), g, dev, torch.bfloat16, 4.0)}
    got = nn.linear(p, x).float()
    want = (x.float() @ p["w"].float() + p["b"].float()).to(torch.bfloat16).float()
    diff = (got - want).abs()
    assert bool((diff <= want.abs() * 2.0 ** -7 + 1e-4).all())
    assert float((diff > 0).float().mean()) <= 0.01
    w3 = randn((4, 512, 960), g, dev, torch.bfloat16, 0.05)
    s = randn((4, 8, 512), g, dev, torch.bfloat16)
    assert torch.allclose(nn.matmul_f32(s, w3), s.float() @ w3.float(), rtol=1e-5, atol=1e-4)


def test_synthesize_padded_queues_a_batch_without_a_sync(dev):
    """synthesize_padded(fetch=False) returns the card's tensor without
    waiting for the card: PyTorch raises on any synchronizing call in
    "error" sync-debug mode. Small widths that the kernels take (DiT head dim
    120, encoder head dim 64). A captured bucket replays; a capture itself
    synchronizes the card, so the eager function that is captured runs
    there too, at buckets it has not run, which covers the tables made on
    first use."""
    import numpy as np

    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.codec import CodecConfig
    from smalltts_tpu_torch.models.dit import DiTConfig
    from smalltts_tpu_torch.models.encoder import EncoderConfig

    enc = EncoderConfig(model_size=128, num_layers=2, num_heads=2, intermediate_size=256, norm_eps=1e-6)
    cfg = BackboneConfig(hidden_dim=240, phoneme_dim=128, text=enc, style=enc,
                         dit=DiTConfig(phoneme_dim=128, hidden_dim=240, n_blocks=2, heads=2))
    g = gen(dev, 12)
    params = redraw_zero_init(init_backbone(g, cfg, device=dev), g)
    tts = SmallTTS(params, cfg=cfg, codec_cfg=CodecConfig(channels=(16, 16, 16, 8, 8, 4)), pcm16_out=True)
    rs = np.random.RandomState(0)

    def batch(R, P, T):
        return (rs.randn(2, R, 64).astype(np.float32), np.array([R, R // 2]), rs.randint(1, 198, (2, P)),
                np.array([P, P // 3]), np.array([T, T // 2]), T)

    tts.synthesize_padded(*batch(64, 128, 16))  # builds the kernels, captures the bucket's graph
    tts.synthesize_padded(*batch(256, 384, 40))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tts.synthesize_padded(*batch(256, 384, 40), fetch=False)  # a replay
        # the eager function, as captured, at buckets it has not run: its tables are made on first use
        r, rl, ph, pl, sl, T = batch(128, 128, 80)
        eager = tts._synthesize_fn(tts.params, tts.codec_params, tts._tensor(r, tts.dtype),
                                   tts._tensor(rl, torch.int32), tts._tensor(ph, torch.int64),
                                   tts._tensor(pl, torch.int32), tts._tensor(sl, torch.int32), tts._noises(2, T),
                                   t_bucket=T)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.is_cuda and out.dtype == torch.int16 and out.shape == (2, 1, 40 * 3200)
    assert eager.shape == (2, 1, 80 * 3200)
    assert int(out.abs().max()) > 0


@pytest.mark.parametrize("sampler", ["imf", "dmd"])
def test_imf_checkpoint_latents_kernels_vs_plain(dev, sampler):
    """An IMF checkpoint (r_gate from N(0, 0.1)) at small widths that the
    kernels take: IMF-2 and the gated DMD-4 with the kernels against the
    same batch with the plain versions forced, on the same noise (rel-L2
    5e-2, the serve phases' bound for bf16 latents through every step), and
    an IMF batch queues without a synchronizing call."""
    import numpy as np

    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.infer.sampler import noise_draws, sample_latents
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.codec import CodecConfig
    from smalltts_tpu_torch.models.dit import DiTConfig
    from smalltts_tpu_torch.models.encoder import EncoderConfig

    enc = EncoderConfig(model_size=128, num_layers=2, num_heads=2, intermediate_size=256, norm_eps=1e-6)
    cfg = BackboneConfig(hidden_dim=240, phoneme_dim=128, text=enc, style=enc,
                         dit=DiTConfig(phoneme_dim=128, hidden_dim=240, n_blocks=2, heads=2))
    g = gen(dev, 14)
    params = redraw_zero_init(init_backbone(g, cfg, device=dev), g)
    params["r_gate"] = 0.1 * torch.randn((240,), generator=g, device=dev)
    tts = SmallTTS(params, cfg=cfg, codec_cfg=CodecConfig(channels=(16, 16, 16, 8, 8, 4)), pcm16_out=True,
                   sampler="auto" if sampler == "imf" else sampler)
    assert tts.sampler == sampler and tts.num_steps == (2 if sampler == "imf" else 4)
    rs = np.random.RandomState(1)
    T_ = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
    args = (tts.params, cfg, T_(rs.randn(2, 64, 64), tts.dtype), T_([64, 30], torch.int32),
            T_(rs.randint(1, 198, (2, 128)), torch.int64), T_([128, 40], torch.int32), T_([16, 9], torch.int32))
    noises = torch.randn((noise_draws(sampler, tts.num_steps), 2, 16, 64), generator=g, device=dev).to(tts.dtype)
    with torch.inference_mode():
        lat_k = sample_latents(*args, num_steps=tts.num_steps, noises=noises, sampler=sampler)
        with kernels.force_plain():
            lat_p = sample_latents(*args, num_steps=tts.num_steps, noises=noises, sampler=sampler)
    rel_l2 = float((lat_k.float() - lat_p.float()).norm() / lat_p.float().norm())
    assert bool(torch.isfinite(lat_k).all()) and rel_l2 <= 5e-2
    b = (rs.randn(2, 64, 64).astype(np.float32), np.array([64, 30]), rs.randint(1, 198, (2, 128)),
         np.array([128, 40]), np.array([16, 9]), 16)
    tts.synthesize_padded(*b)  # captures the bucket's graph
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tts.synthesize_padded(*b, fetch=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.dtype == torch.int16 and int(out.abs().max()) > 0


# the DiT's four products: K, W's width, epilogue
PRODUCTS = {"qkvg": (960, 3840, "bias"), "to_out": (960, 960, "resid_masked"), "w13": (960, 4800, "swiglu"),
            "w2": (2400, 960, "resid")}


def run_product(dev, epi, B, T, K_, N, w8, seed):
    """One GEMM epilogue on the card against its plain version; bf16 or
    int8 W ((1, N) scales, as a layer of the stream weights)."""
    g = gen(dev, seed)
    a = randn((B, T, K_), g, dev, torch.bfloat16)
    w = randn((K_, N), g, dev, torch.float32, 1 / math.sqrt(K_))
    if w8:
        w, scale = W.quantize_w8(w)
        scale = scale[None]
    else:
        w, scale = w.to(torch.bfloat16), None
    b = randn((N,), g, dev, torch.bfloat16, 0.1)
    name = {"bias": "gemm_bias", "swiglu": "gemm_swiglu"}.get(epi, "gemm_residual") + ("_w8" if w8 else "")
    n0 = kernels.LAUNCHES.get(name, 0)
    if epi == "bias":
        got, want = K.gemm_bias(a, w, b, w_scale=scale), K.gemm_bias_plain(a, w, b, w_scale=scale)
    elif epi == "swiglu":
        got, want = K.gemm_swiglu(a, w, b, w_scale=scale), K.gemm_swiglu_plain(a, w, b, w_scale=scale)
    else:
        x = randn((B, T, N), g, dev, torch.bfloat16)
        gate = randn((B, N), g, dev, torch.bfloat16)
        mask, bias = (key_mask(B, T, g, dev), None) if epi == "resid_masked" else (None, b)
        want = K.gemm_residual_plain(a, w, bias, x.clone(), gate, mask, w_scale=scale)
        got = K.gemm_residual(a, w, bias, x.clone(), gate, mask, w_scale=scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert rel(got, want) <= 2e-2


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("M", [40, 128, 200, 320])
@pytest.mark.parametrize("product", list(PRODUCTS))
def test_gemm_products_at_served_rows(dev, product, M, w8):
    """Every product of a layer, bf16 and int8 W, at M = B*T rows: 40 and
    200 are ragged (not multiples of the 64-row tile); w13's output (2400)
    and w2's K (2400) end in half tiles. w2 at M = 40, 128 and 200 splits K
    over a cluster of 4, 4 and 3 ranks (the merge through distributed shared
    memory); the other products run one rank per tile."""
    K_, N, epi = PRODUCTS[product]
    run_product(dev, epi, 8, M // 8, K_, N, w8, seed=M + K_ + N)


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("epi", ["bias", "swiglu", "resid", "resid_masked"])
def test_gemm_ragged_tails(dev, epi, w8):
    """N = 208 and K = 72: the last column tile and the last k tile are
    mostly past the edge (TMA zero fill, masked stores); one row block."""
    run_product(dev, epi, 2, 9, 72, 416 if epi == "swiglu" else 208, w8, seed=99)


def ulps_apart(got, want, before=None):
    """(share of elements that differ, largest difference in bf16 ulps of
    the larger of |want| and |before|, the value before the last op)."""
    got, want = got.float(), want.float()
    mag = want.abs() if before is None else torch.maximum(want.abs(), before.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
    return float((got != want).float().mean()), float(((got - want).abs() / ulp).max())


def pair_max(y):
    """|y| widened to the larger of each RoPE pair (d, d + 1)."""
    y = y.float().abs().unflatten(-1, (-1, 2))
    return y.amax(-1, keepdim=True).expand(y.shape).flatten(-2)


def identity(K_, copies, w8, dev):
    """[I | I | ...] (K_, copies K_): bf16, or int8 ones with scale 1."""
    w = torch.eye(K_, device=dev).repeat(1, copies)
    if w8:
        return w.to(torch.int8), torch.ones((1, copies * K_), device=dev)
    return w.to(torch.bfloat16), None


def rows_of(M):
    """(B, T) of a served row count: T 16 at M = 128, else 40."""
    T = 16 if M == 128 else 40
    return M // T, T


@pytest.mark.parametrize("M", [40, 128, 200, 320])
def test_adaln_kernel_rounds_like_plain(dev, M):
    """The adaLN's four roundings against the plain version: at most 1e-4
    of elements differ, by at most two ulps of n * (1 + scale) (which +
    shift may cancel); a modulation per batch row and one shared by the
    batch."""
    B, T = rows_of(M)
    g = gen(dev, 61 + M)
    x, sh, sc = adaln_inputs(g, dev, B, T, 960)
    n0 = kernels.LAUNCHES.get("adaln_modulate", 0)
    for shift, scale in ((sh, sc), (sh[:1].expand(B, -1), sc[:1].expand(B, -1))):
        got, want = K.adaln_modulate(x, shift, scale), K.adaln_modulate_plain(x, shift, scale)
        share, worst = ulps_apart(got, want, want.float() - shift[:, None].float())
        assert share <= 1e-4 and worst <= 2.0, (share, worst)
    assert kernels.LAUNCHES["adaln_modulate"] == n0 + 2


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("M", [40, 128, 200, 320])
def test_qkvg_rounding_points_on_an_identity_weight(dev, M, w8):
    """W = [I | I | I | I] after the adaLN kernel, then the q/k norm kernel:
    the product is h itself, so the adaLN (four roundings), bias, q/k
    RMSNorm and RoPE must give the plain versions' bits: at most 1e-4 of
    elements differ, by at most three ulps of the larger of the pair a RoPE
    rotation mixes."""
    B, T = rows_of(M)
    H = 960
    g = gen(dev, 31 + M)
    x, sh, sc = adaln_inputs(g, dev, B, T, H)
    w, scale = identity(H, 4, w8, dev)
    b = randn((4 * H,), g, dev, torch.bfloat16, 0.1)
    qs, ks, cos, sin = qk_tables(g, dev, 8, 120, T, 64)
    got = K.qk_norm_rope(K.gemm_bias(K.adaln_modulate(x, sh, sc), w, b, w_scale=scale), qs, ks, cos, sin)
    qkvg = K.gemm_bias_plain(K.adaln_modulate_plain(x, sh, sc), w, b, w_scale=scale)
    want = K.qk_norm_rope_plain(qkvg.clone(), qs, ks, cos, sin)
    unrotated = K.qk_norm_rope_plain(qkvg.clone(), qs, ks, cos[:, :0], sin[:, :0])
    share, worst = ulps_apart(got, want, pair_max(unrotated))
    assert share <= 1e-4 and worst <= 3.0, (share, worst)


@pytest.mark.parametrize("heads,D,rot,T", [(8, 120, 64, 40), (8, 120, 64, 16), (1, 56, 16, 9), (2, 256, 64, 12),
                                           (3, 64, 0, 5), (4, 8, 8, 33)])
def test_qk_norm_rope_kernel_shapes(dev, heads, D, rot, T):
    """The q/k norm kernel alone, in place, on a qkvg buffer of 4 heads D
    columns, bit-equal to the plain version up to 1e-4 of elements three
    ulps of a RoPE pair away: one half-warp a head (D 120: 15 of 16 lanes;
    D 256: two 16-byte chunks a lane; D 8: one), RoPE on none, some or all
    lanes; v and gate untouched."""
    g = gen(dev, heads * D + rot + T)
    qkvg = randn((3, T, 4 * heads * D), g, dev, torch.bfloat16, 2.0)
    qs, ks, cos, sin = qk_tables(g, dev, heads, D, T, rot)
    n0 = kernels.LAUNCHES.get("qk_norm_rope", 0)
    got = K.qk_norm_rope(qkvg.clone(), qs, ks, cos, sin)
    want = K.qk_norm_rope_plain(qkvg.clone(), qs, ks, cos, sin)
    unrotated = K.qk_norm_rope_plain(qkvg.clone(), qs, ks, cos[:, :0], sin[:, :0])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["qk_norm_rope"] == n0 + 1
    assert torch.equal(got[..., 2 * heads * D:], qkvg[..., 2 * heads * D:])
    share, worst = ulps_apart(got, want, pair_max(unrotated))
    assert share <= 1e-4 and worst <= 3.0, (share, worst)


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("M", [40, 320])
def test_swiglu_adaln_on_an_identity_weight(dev, M, w8):
    """W = [I | I] after the adaLN kernel: silu(h + b1) * (h + b3). A flip
    of h enters both factors, so a differing element may be four ulps away;
    at most 1e-4 of elements differ."""
    B, T = rows_of(M)
    g = gen(dev, 41 + M)
    x, sh, sc = adaln_inputs(g, dev, B, T, 960)
    w, scale = identity(960, 2, w8, dev)
    b = randn((2 * 960,), g, dev, torch.bfloat16, 0.1)
    got = K.gemm_swiglu(K.adaln_modulate(x, sh, sc), w, b, w_scale=scale)
    want = K.gemm_swiglu_plain(K.adaln_modulate_plain(x, sh, sc), w, b, w_scale=scale)
    share, worst = ulps_apart(got, want)
    assert share <= 1e-4 and worst <= 4.0, (share, worst)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("M", [40, 128, 200, 320])
def test_residual_rounding_points_on_an_identity_weight(dev, M, w8, masked):
    """W = I: x + tanh(gate) * (a + b), four roundings (the row mask zeroes
    the product), bit-equal to the plain version up to 1e-4 of elements one
    ulp away."""
    B, T = rows_of(M)
    H = 960
    g = gen(dev, 51 + M)
    w, scale = identity(H, 1, w8, dev)
    a, x = randn((B, T, H), g, dev, torch.bfloat16), randn((B, T, H), g, dev, torch.bfloat16, 2.0)
    gate, b = randn((B, H), g, dev, torch.bfloat16), randn((H,), g, dev, torch.bfloat16, 0.1)
    mask = key_mask(B, T, g, dev) if masked else None
    got = K.gemm_residual(a, w, b, x.clone(), gate, mask, w_scale=scale)
    want = K.gemm_residual_plain(a, w, b, x.clone(), gate, mask, w_scale=scale)
    share, worst = ulps_apart(got, want)
    assert share <= 1e-4 and worst <= 1.0, (share, worst)


@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("Tq", [1, 16, 40, 384])
def test_attention_query_lengths(dev, Tq, two):
    """bf16 at Tq 1 / 16 / 40 (the DiT's buckets, keys split across a
    cluster) and 384 (the text encoder), with and without the second key
    source (448 cross keys, D 120, gated)."""
    B, H = 8, 8 if two else 4
    D = 120 if two else 128
    g = gen(dev, Tq + two)
    q, k, v = (randn((B, H, Tq, D), g, dev, torch.bfloat16) for _ in range(3))
    m = key_mask(B, Tq, g, dev)
    extra = dict(k2=randn((B, H, 448, D), g, dev, torch.bfloat16), v2=randn((B, H, 448, D), g, dev, torch.bfloat16),
                 key_mask2=key_mask(B, 448, g, dev), gate=randn((B, H, Tq, D), g, dev, torch.bfloat16)) if two else {}
    got = A.fused_attention(q, k, v, m, **extra)
    assert rel(got, A.attention_plain(q, k, v, m, **extra)) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("B,Tq,S2,splits", [(8, 16, 60, 2), (8, 40, 150, 4), (8, 16, 150, 4), (8, 40, 448, 4),
                                            (4, 16, 420, 8), (4, 40, 448, 8)])
def test_attention_split_merge(dev, B, Tq, S2, splits):
    """The cluster merge against the plain versions, at shapes where the
    kernel itself splits the keys: (b, h) x q tiles below the SM count, so
    `splits` is the split a 132-SM H100 chooses (2, 4 or 8 ranks; 448 cross
    keys at B 8 give 4 ranks of 2 tiles, the served shape). The cross
    source's second tile is masked in every row (a split of only -1e9 keys
    at one tile per rank); batch row 1 has keys only in the second source,
    the last row none (a uniform average). The result goes to a strided
    (B, T, H*D) view, as the DiT writes it."""
    H, D = 8, 120
    g = gen(dev, 21 + S2)
    q, k, v, gate = (randn((B, H, Tq, D), g, dev, torch.bfloat16) for _ in range(4))
    k2, v2 = randn((B, H, S2, D), g, dev, torch.bfloat16), randn((B, H, S2, D), g, dev, torch.bfloat16)
    m1, m2 = key_mask(B, Tq, g, dev), key_mask(B, S2, g, dev)
    m1[1] = False
    m2[1, :9] = True
    m2[:, A.KEY_TILE:2 * A.KEY_TILE] = False
    m2[-1] = False
    buf = torch.zeros((B, Tq, H * D), device=dev, dtype=torch.bfloat16)
    out = buf.unflatten(-1, (H, D)).transpose(1, 2)
    n0 = kernels.LAUNCHES.get("attention", 0)
    A.fused_attention(q, k, v, m1, k2, v2, m2, gate=gate, out=out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention"] == n0 + 1
    assert bool(torch.isfinite(buf).all())
    assert rel(out, A.attention_plain(q, k, v, m1, k2, v2, m2, gate=gate)) <= TOL[torch.bfloat16]
    assert rel(out, A.attention_split_plain(q, k, v, m1, k2, v2, m2, gate=gate, splits=splits)) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [16, 40])
def test_attention_gate_rounds_like_plain(dev, dtype, T):
    """The gated DiT attention at the served shapes (cross Sc 448, where the
    bf16 kernel splits the keys over a cluster): within the attention
    tolerance of the plain version, and the gate stage alone, applied by the
    plain `_gated` to the kernel's own ungated output, equal to the kernel's
    gated output on all but 1e-4 of elements and within one ulp there (the
    card's exp in PyTorch and in the kernel may round a hair apart)."""
    B, H, Sc, D = 8, 8, 448, 120
    g = gen(dev, 90 + T)
    q, k, v = (randn((B, H, T, D), g, dev, dtype) for _ in range(3))
    gate = randn((B, H, T, D), g, dev, dtype, 2.0)
    k2, v2 = (randn((B, H, Sc, D), g, dev, dtype) for _ in range(2))
    m1, m2 = key_mask(B, T, g, dev), key_mask(B, Sc, g, dev)
    got = A.fused_attention(q, k, v, m1, k2, v2, m2, gate=gate)
    ungated = A.fused_attention(q, k, v, m1, k2, v2, m2)
    assert rel(got, A.attention_plain(q, k, v, m1, k2, v2, m2, gate=gate)) <= TOL[dtype]
    stage = A._gated(ungated, dtype, gate)
    if dtype == torch.float32:
        assert rel(got, stage) <= 1e-6
    else:
        share, worst = ulps_apart(got, stage)
        assert share <= 1e-4 and worst <= 1.0, (share, worst)

"""The port's ONNX import path (smalltts_tpu_torch/onnxtorch) against the JAX
package's (smalltts_tpu/onnxjax) on the same exported bytes, on the CPU.

1. The proto reader: the same nodes, attributes, initializers and opsets
   as the JAX package's reader.
2. OnnxFunction: every module and hand-written graph of
   tests/test_onnxjax.py, exported by `torch.onnx.export` (its `export`),
   through both interpreters and the torch module itself. Tolerance: the
   port against JAX 1e-5 absolute + 1e-5 relative (fp32 sums in another
   order; 1e-2 for the fp16 case), the port against the module the JAX
   test's own tolerance.
3. OnnxCodec and SmallTTS(codec=...) on the mini VibeVoice assets of
   tests/test_onnx_codec.py; the codec choice ("auto" with and without
   assets, "onnx", an instance, an unknown name) as the JAX pipeline
   chooses.
4. ImportedSmallTTS on the mini published graphs of
   tests/test_imported_pipeline.py, with injected noise, against the JAX
   ImportedSmallTTS (2e-5 absolute, 1e-4 relative, the JAX test's own).
5. The port's own tiny models exported by onnxtorch.export: the codec with
   dynamic axes through OnnxCodec against the native codec (1e-5 of the
   largest value), and the condition encoder, cached DiT step and decoder
   through ImportedSmallTTS against the torch modules (1e-4).
6. One node of each op type and opset form (attribute and input forms,
   negative steps and pads, ceil-mode pooling, recurrences with initial
   states) through both interpreters (1e-5 absolute + 1e-5 relative).
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn as nn  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from smalltts_tpu.onnxjax import OnnxFunction as JOnnxFunction  # noqa: E402
from smalltts_tpu.onnxjax import parse_model as j_parse_model  # noqa: E402
from smalltts_tpu.onnxjax import proto as jproto  # noqa: E402
from smalltts_tpu_torch.onnxtorch import OnnxFunction, parse_model  # noqa: E402
from smalltts_tpu_torch.onnxtorch import proto  # noqa: E402
from tests.test_imported_pipeline import LAT as IMP_LAT  # noqa: E402
from tests.test_imported_pipeline import mini_published  # noqa: E402,F401
from tests.test_onnx_codec import HOP as CODEC_HOP  # noqa: E402
from tests.test_onnx_codec import LATENT, mini_assets  # noqa: E402,F401
from tests.test_onnxjax import MiniDecoder, MiniEncoder, export  # noqa: E402

sys.path.insert(0, "tests")
from tiny import TINY_BACKBONE, TINY_CODEC  # noqa: E402

P = jproto  # the hand-written graphs are built with the JAX package's writer, then read by both


# ----------------------------------------------------------- the exported cases


class Conv1dVariants(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Conv1d(8, 16, 5, stride=2, padding=2)
        self.b = nn.Conv1d(16, 16, 3, padding=2, dilation=2)
        self.c = nn.Conv1d(16, 16, 7, padding=3, groups=16)
        self.d = nn.Conv1d(16, 4, 1)

    def forward(self, x):
        return self.d(self.c(self.b(self.a(x))))


class Conv2dPool(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.pool = nn.MaxPool2d(2, 2)
        self.avg = nn.AvgPool2d(3, stride=1, padding=1)

    def forward(self, x):
        return self.avg(self.pool(F.relu(self.conv(x))))


class ConvTranspose1dVariants(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.ConvTranspose1d(16, 8, 4, stride=2, padding=1)
        self.b = nn.ConvTranspose1d(8, 8, 5, stride=3, padding=1, output_padding=2)
        self.c = nn.ConvTranspose1d(8, 8, 4, stride=2, padding=1, groups=8)

    def forward(self, x):
        return self.c(self.b(self.a(x)))


class Mlp(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1, self.ln, self.fc2 = nn.Linear(32, 64), nn.LayerNorm(64), nn.Linear(64, 16)

    def forward(self, x):
        return self.fc2(F.gelu(self.ln(self.fc1(x))))


class ConvNextBlock(nn.Module):
    def __init__(self, dim=32):
        super().__init__()
        self.dw = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim)
        self.p1, self.p2 = nn.Linear(dim, dim * 4), nn.Linear(dim * 4, dim)

    def forward(self, x):
        h = self.dw(x).transpose(1, 2)
        return x + self.p2(F.gelu(self.p1(self.norm(h)))).transpose(1, 2)


class Attn(nn.Module):
    def __init__(self, d=32, h=4):
        super().__init__()
        self.h = h
        self.qkv, self.out = nn.Linear(d, 3 * d), nn.Linear(d, d)

    def forward(self, x):
        b, t, d = x.shape
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q, k, v = (a.view(b, t, self.h, -1).transpose(1, 2) for a in (q, k, v))
        a = torch.softmax(q @ k.transpose(-1, -2) / (d // self.h) ** 0.5, -1)
        return self.out((a @ v).transpose(1, 2).reshape(b, t, d))


class Norms(nn.Module):
    def __init__(self):
        super().__init__()
        self.gn, self.inorm, self.bn = nn.GroupNorm(4, 16), nn.InstanceNorm1d(16, affine=True), nn.BatchNorm1d(16)

    def forward(self, x):
        return self.bn(self.inorm(self.gn(x)))


def norms():
    m = Norms()
    m.eval()
    m.bn.running_mean.uniform_(-1, 1)
    m.bn.running_var.uniform_(0.5, 2.0)
    return m


class ActivationZoo(nn.Module):
    def __init__(self):
        super().__init__()
        self.prelu = nn.PReLU(8)

    def forward(self, x):
        x = F.silu(x) + F.mish(x)
        x = F.elu(x) + F.leaky_relu(x, 0.2)
        x = F.hardswish(x) + F.hardsigmoid(x)
        x = F.softplus(x) + torch.tanh(x) + F.selu(x)
        return self.prelu(x)


class Snake(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.rand(8, 1) + 0.5)

    def forward(self, x):
        return x + torch.sin(self.alpha * x) ** 2 / self.alpha


class PadModes(nn.Module):
    def forward(self, x):
        return (F.pad(x, (2, 3), mode="constant", value=1.5), F.pad(x, (2, 2), mode="reflect"),
                F.pad(x, (1, 4), mode="replicate"))


class SliceChunkCatFlip(nn.Module):
    def forward(self, x):
        a, b = x.chunk(2, dim=1)
        d = torch.cat([b, a], dim=1)[:, :, 1:-1]
        return torch.flip(d, dims=[-1])[:, ::2]


class Reductions(nn.Module):
    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        z = (x - mu) / torch.sqrt(((x - mu) ** 2).mean(dim=-1, keepdim=True) + 1e-5)
        return z.sum(dim=1), z.amax(dim=-1), z.abs().amin(dim=0)


class WhereClipCast(nn.Module):
    def forward(self, x):
        y = torch.clamp(torch.where(x > 0, x, x * 0.1), -0.5, 0.5)
        return y + (x > 0.2).float()


class ExpandRepeat(nn.Module):
    def forward(self, x):
        return x.unsqueeze(1).expand(-1, 3, -1).reshape(x.shape[0], -1), x.repeat(2, 1)


class Upsample(nn.Module):
    def forward(self, x):
        return (F.interpolate(x, scale_factor=2.0, mode="nearest"),
                F.interpolate(x, scale_factor=2.0, mode="linear", align_corners=False),
                F.interpolate(x, scale_factor=2.0, mode="linear", align_corners=True))


class Recurrent(nn.Module):
    def __init__(self, rnn):
        super().__init__()
        self.rnn = rnn

    def forward(self, x):
        y, h = self.rnn(x)
        return (y, *h) if isinstance(h, tuple) else (y, h)


class EncodecBottleneck(nn.Module):
    def __init__(self):
        super().__init__()
        self.down, self.lstm, self.out = nn.Conv1d(1, 8, 8, stride=4, padding=2), nn.LSTM(8, 8), nn.Conv1d(8, 4, 3,
                                                                                                            padding=1)

    def forward(self, x):
        h = torch.relu(self.down(x))
        seq = h.permute(2, 0, 1)
        y, _ = self.lstm(seq)
        return self.out((y + seq).permute(1, 2, 0))


def _rand(*shape):
    return torch.randn(*shape)


# name -> (seed, module factory, example args, dynamic_axes, the JAX test's atol,
#          args to run at (None: the example), port-vs-JAX tolerance)
MODULE_CASES = {
    "conv1d_variants": (0, Conv1dVariants, lambda: (_rand(2, 8, 40),), None, 1e-5, None),
    "conv2d_and_pool": (0, Conv2dPool, lambda: (_rand(1, 3, 16, 16),), None, 1e-5, None),
    "conv_transpose1d_variants": (0, ConvTranspose1dVariants, lambda: (_rand(2, 16, 10),), None, 1e-4, None),
    "depthwise_conv_transpose": (0, lambda: nn.ConvTranspose1d(64, 64, 8, stride=4, padding=2, groups=64),
                                 lambda: (_rand(2, 64, 20),), None, 1e-5, None),
    "mlp_gemm_layernorm_gelu": (0, Mlp, lambda: (_rand(4, 32),), None, 1e-5, None),
    "convnext_block": (0, ConvNextBlock, lambda: (_rand(2, 32, 24),), None, 2e-5, None),
    "attention_block": (0, Attn, lambda: (_rand(2, 10, 32),), None, 1e-5, None),
    "norms": (0, norms, lambda: (_rand(2, 16, 12),), None, 1e-5, None),
    "activation_zoo": (0, ActivationZoo, lambda: (_rand(2, 8, 10),), None, 1e-5, None),
    "snake": (0, Snake, lambda: (_rand(2, 8, 16),), None, 1e-5, None),
    "weight_norm_conv": (0, lambda: nn.utils.parametrizations.weight_norm(nn.Conv1d(8, 16, 3, padding=1)),
                         lambda: (_rand(2, 8, 12),), None, 1e-5, None),
    "pad_modes": (0, PadModes, lambda: (_rand(2, 4, 16),), None, 1e-5, None),
    "slice_chunk_cat_flip": (0, SliceChunkCatFlip, lambda: (_rand(2, 8, 16),), None, 1e-5, None),
    "embedding_gather": (0, lambda: nn.Embedding(100, 16), lambda: (torch.randint(0, 100, (2, 12)),), None, 1e-5,
                         None),
    "reductions_and_stats": (0, Reductions, lambda: (_rand(3, 5, 7),), None, 1e-5, None),
    "where_clip_cast": (0, WhereClipCast, lambda: (_rand(4, 6),), None, 1e-5, None),
    "expand_repeat_broadcast": (0, ExpandRepeat, lambda: (_rand(2, 5),), None, 1e-5, None),
    "upsample_nearest_and_linear": (0, Upsample, lambda: (_rand(2, 4, 12),), None, 1e-5, None),
    "lstm_forward": (0, lambda: Recurrent(nn.LSTM(input_size=6, hidden_size=5)), lambda: (_rand(7, 2, 6),), None,
                     1e-5, None),
    "lstm_bidirectional": (0, lambda: Recurrent(nn.LSTM(input_size=6, hidden_size=5, bidirectional=True)),
                           lambda: (_rand(7, 2, 6),), None, 1e-5, None),
    "gru_forward": (1, lambda: Recurrent(nn.GRU(input_size=4, hidden_size=3)), lambda: (_rand(5, 2, 4),), None,
                    1e-5, None),
    "gru_bidirectional": (1, lambda: Recurrent(nn.GRU(input_size=4, hidden_size=3, bidirectional=True)),
                          lambda: (_rand(5, 2, 4),), None, 1e-5, None),
    "encodec_lstm_bottleneck": (2, EncodecBottleneck, lambda: (_rand(2, 1, 64),), None, 1e-5, None),
    "mini_encoder_new_length": (0, MiniEncoder, lambda: (_rand(1, 1, 80),), {"x": {0: "b", 2: "t"}}, 2e-5,
                                lambda: (_rand(3, 1, 200),)),
    "mini_decoder": (1, MiniDecoder, lambda: (_rand(2, 8, 16),), None, 5e-5, None),
    "fp16_linear": (0, lambda: nn.Linear(8, 4).half(), lambda: (_rand(2, 8).half(),), None, 1e-2, None),
}


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64),
                      np.float64)


def _close(got, want, atol, rtol=1e-5):
    gots = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    assert len(gots) == len(wants)
    for g, w in zip(gots, wants):
        assert g.shape == tuple(np.shape(w)), (g.shape, np.shape(w))
        np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_onnx_function_equals_jax_and_the_module(case):
    seed, make, example, dyn, atol, run_args = MODULE_CASES[case]
    torch.manual_seed(seed)
    module = make()
    args = example()
    blob = export(module, args, dynamic_axes=dyn)
    if run_args is not None:
        args = run_args()
    with torch.no_grad():
        want = module(*args)
    fn = OnnxFunction(parse_model(blob))
    got = fn(fn.params, *args)
    jfn = JOnnxFunction(j_parse_model(blob))
    jgot = jax.jit(jfn)(jfn.params, *[a.numpy() for a in args])
    _close(got, want, atol)
    _close(got, tuple(np.asarray(j) for j in jgot) if isinstance(jgot, tuple) else np.asarray(jgot),
           1e-2 if case == "fp16_linear" else 1e-5)
    if case == "fp16_linear":
        assert all(v.dtype == torch.float16 for v in fn.params.values())


# ----------------------------------------------------------- hand-written graphs


def _single_op(op_type, n_in, attrs=None, inits=None):
    inits = inits or {}
    in_names = [f"x{i}" for i in range(n_in)]
    g = P.Graph(nodes=[P.Node(op_type=op_type, inputs=in_names + list(inits), outputs=["y"], attributes=attrs or {})],
                initializers=[P.numpy_to_tensor(k, v) for k, v in inits.items()],
                inputs=[P.make_value_info(n, 1, []) for n in in_names],
                outputs=[P.make_value_info("y", 1, [])])
    return P.serialize_model(P.Model(graph=g))


def _reshape_chain():
    nodes = [
        P.Node(op_type="Transpose", inputs=["x"], outputs=["xt"], attributes={"perm": P.attr_ints("perm", [0, 2, 1])}),
        P.Node(op_type="Shape", inputs=["x"], outputs=["shp"]),
        P.Node(op_type="Constant", outputs=["i0"], attributes={"value": P.attr_t("value", np.array([0], np.int64))}),
        P.Node(op_type="Constant", outputs=["i2"], attributes={"value": P.attr_t("value", np.array([2], np.int64))}),
        P.Node(op_type="Constant", outputs=["four"], attributes={"value": P.attr_t("value", np.array([4], np.int64))}),
        P.Node(op_type="Constant", outputs=["neg1"],
               attributes={"value": P.attr_t("value", np.array([-1], np.int64))}),
        P.Node(op_type="Gather", inputs=["shp", "i0"], outputs=["b"]),
        P.Node(op_type="Gather", inputs=["shp", "i2"], outputs=["t"]),
        P.Node(op_type="Div", inputs=["t", "four"], outputs=["t4"]),
        P.Node(op_type="Concat", inputs=["b", "t4", "neg1"], outputs=["tgt"], attributes={"axis": P.attr_i("axis", 0)}),
        P.Node(op_type="Reshape", inputs=["xt", "tgt"], outputs=["y"]),
    ]
    g = P.Graph(nodes=nodes, inputs=[P.make_value_info("x", 1, ["b", 8, "t"])],
                outputs=[P.make_value_info("y", 1, ["b", "t4", 32])])
    return P.serialize_model(P.Model(graph=g, opset={"": 17}))


def _onehot_int():
    g = P.Graph(name="oh", nodes=[P.Node(op_type="OneHot", inputs=["idx", "depth", "vals"], outputs=["y"])],
                initializers=[P.numpy_to_tensor("depth", np.array(4, np.int64)),
                              P.numpy_to_tensor("vals", np.array([0, 1], np.int64))],
                inputs=[P.make_value_info("idx", 7, [3])], outputs=[P.make_value_info("y", 7, [3, 4])])
    return P.serialize_model(P.Model(ir_version=8, graph=g, opset={"": 17}))


RS = np.random.RandomState(0)
X234 = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
GRAPH_CASES = {
    "reshape_chain_b2_t16": (_reshape_chain, [RS.randn(2, 8, 16).astype(np.float32)],
                             lambda x: x.transpose(0, 2, 1).reshape(2, 4, 32)),
    "reshape_chain_b3_t32": (_reshape_chain, [RS.randn(3, 8, 32).astype(np.float32)],
                             lambda x: x.transpose(0, 2, 1).reshape(3, 8, 32)),
    "flatten_axis_-1": (lambda: _single_op("Flatten", 1, {"axis": P.attr_i("axis", -1)}), [X234],
                        lambda x: x.reshape(6, 4)),
    "flatten_axis_-3": (lambda: _single_op("Flatten", 1, {"axis": P.attr_i("axis", -3)}), [X234],
                        lambda x: x.reshape(1, 24)),
    "pow_int_base_float_exponent": (lambda: _single_op("Pow", 2),
                                    [np.array([4, 9], np.int64), np.array(0.5, np.float32)], lambda a, b: [2, 3]),
    "reduce_sum_empty_axes": (lambda: _single_op("ReduceSum", 1, {"keepdims": P.attr_i("keepdims", 0)},
                                                 {"axes": np.zeros((0,), np.int64)}),
                              [np.arange(6, dtype=np.float32).reshape(2, 3)], lambda x: 15.0),
    "onehot_out_of_range": (lambda: _single_op("OneHot", 1, {"axis": P.attr_i("axis", -1)},
                                               {"depth": np.array(3, np.int64),
                                                "values": np.array([0.0, 1.0], np.float32)}),
                            [np.array([0, 3, -1, -4], np.int64)],
                            lambda x: [[1, 0, 0], [0, 0, 0], [0, 0, 1], [0, 0, 0]]),
    "onehot_keeps_int_dtype": (_onehot_int, [np.array([0, 2, -1], np.int64)],
                               lambda x: [[1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]),
    "average_pool_ceil_mode": (lambda: _single_op("AveragePool", 1, {
        "kernel_shape": P.attr_ints("kernel_shape", [2]), "strides": P.attr_ints("strides", [2]),
        "ceil_mode": P.attr_i("ceil_mode", 1)}), [np.arange(5, dtype=np.float32)[None, None]],
        lambda x: [[[0.5, 2.5, 4.0]]]),
    "conv_transpose_output_shape": (lambda: _single_op("ConvTranspose", 2, {
        "strides": P.attr_ints("strides", [2]), "kernel_shape": P.attr_ints("kernel_shape", [4]),
        "output_shape": P.attr_ints("output_shape", [11])}),
        [RS.randn(1, 2, 5).astype(np.float32), RS.randn(2, 3, 4).astype(np.float32)],
        lambda x, w: F.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w), stride=2).numpy()[:, :, 1:]),
    "argmax_first": (lambda: _single_op("ArgMax", 1, {"axis": P.attr_i("axis", 1), "keepdims": P.attr_i("keepdims", 0)}),
                     [np.asarray([[3.0, 1.0, 3.0], [1.0, 2.0, 2.0]], np.float32)], lambda x: [0, 1]),
    "argmax_select_last_index": (lambda: _single_op("ArgMax", 1, {
        "axis": P.attr_i("axis", 1), "keepdims": P.attr_i("keepdims", 0),
        "select_last_index": P.attr_i("select_last_index", 1)}),
        [np.asarray([[3.0, 1.0, 3.0], [1.0, 2.0, 2.0]], np.float32)], lambda x: [2, 2]),
    "reshape_initializer_shape": (lambda: _single_op("Reshape", 1, inits={"shape": np.asarray([2, 6], np.int64)}),
                                  [np.arange(12, dtype=np.float32).reshape(3, 4)], lambda x: x.reshape(2, 6)),
    "expand_initializer_shape": (lambda: _single_op("Expand", 1, inits={"shape": np.asarray([2, 3, 4], np.int64)}),
                                 [np.arange(12, dtype=np.float32).reshape(3, 4)],
                                 lambda x: np.broadcast_to(x, (2, 3, 4))),
    "concat_attribute": (lambda: P.serialize_model(P.Model(graph=P.Graph(
        nodes=[P.Node(op_type="Concat", inputs=["x", "x"], outputs=["y"], attributes={"axis": P.attr_i("axis", 1)})],
        inputs=[P.make_value_info("x", 1, [2, 2])], outputs=[P.make_value_info("y", 1, [2, 4])]))),
        [RS.randn(2, 2).astype(np.float32)], lambda x: np.concatenate([x, x], 1)),
}


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_hand_written_graph_equals_jax(case):
    """Graphs written with the JAX package's proto writer (the cases of
    tests/test_onnxjax.py that torch's exporter cannot produce): the port's
    output equals the expected values (1e-5) and the JAX interpreter's; an
    integral output stays integral."""
    build, args, expect = GRAPH_CASES[case]
    blob = build()
    fn = OnnxFunction(parse_model(blob))
    got = fn(fn.params, *args)
    jfn = JOnnxFunction(j_parse_model(blob))
    jgot = np.asarray(jax.jit(jfn)(jfn.params, *[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(_np(got), np.asarray(expect(*args), np.float64), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(got), jgot.astype(np.float64), atol=1e-5, rtol=1e-5)
    assert got.is_floating_point() == np.issubdtype(jgot.dtype, np.floating)


def test_unsupported_op_and_unimplemented_output_raise():
    g = P.Graph(nodes=[P.Node(op_type="BogusOp9000", inputs=["x"], outputs=["y"])],
                inputs=[P.make_value_info("x", 1, [1])], outputs=[P.make_value_info("y", 1, [1])])
    with pytest.raises(NotImplementedError, match="BogusOp9000"):
        OnnxFunction(parse_model(P.serialize_model(P.Model(graph=g))))
    g = P.Graph(nodes=[
        P.Node(op_type="MaxPool", inputs=["x"], outputs=["y0", "idx"],
               attributes={"kernel_shape": P.attr_ints("kernel_shape", [2]), "strides": P.attr_ints("strides", [2])}),
        P.Node(op_type="Cast", inputs=["idx"], outputs=["y"], attributes={"to": P.attr_i("to", 1)})],
        inputs=[P.make_value_info("x", 1, [])], outputs=[P.make_value_info("y", 1, [])])
    fn = OnnxFunction(parse_model(P.serialize_model(P.Model(graph=g))))
    with pytest.raises(NotImplementedError, match="Indices|idx"):
        fn(fn.params, torch.zeros((1, 1, 4)))


def test_op_vocabulary_equals_jax():
    from smalltts_tpu.onnxjax import interp as jinterp
    from smalltts_tpu_torch.onnxtorch import interp

    assert set(interp._REGISTRY) == set(jinterp._REGISTRY)
    assert len(interp._REGISTRY) > 100


def test_folded_constants_go_to_the_device_once():
    """A numpy constant meeting a tensor is copied once per node, input and
    call signature, then reused: the second call at a signature makes no
    new copy (a CUDA-graph capture may follow the first)."""
    torch.manual_seed(0)
    blob = export(MiniDecoder(), (_rand(1, 4, 16),), dynamic_axes={"z": {0: "b", 1: "t"}})
    fn = OnnxFunction(parse_model(blob))
    fn(fn.params, _rand(1, 4, 16))
    n = len(fn._cache)
    fn(fn.params, _rand(1, 4, 16))
    assert len(fn._cache) == n
    fn(fn.params, _rand(2, 6, 16))
    assert len(fn._cache) > n


# ------------------------------------------------------------------- proto


PROTO_CASES = {
    "conv": lambda: export(nn.Conv1d(4, 8, 3, padding=1), (torch.randn(1, 4, 16),)),
    "mini_encoder_dynamic": lambda: export(MiniEncoder(), (torch.randn(1, 1, 80),),
                                           dynamic_axes={"x": {0: "b", 2: "t"}}),
    "lstm": lambda: export(Recurrent(nn.LSTM(6, 5, bidirectional=True)), (torch.randn(7, 2, 6),)),
    "fp16": lambda: export(nn.Linear(8, 4).half(), (torch.randn(2, 8).half(),)),
    "writer_graph": _reshape_chain,
}


def _attr(a):
    return (a.name, a.type, a.i, a.f, a.s, list(a.ints), list(a.floats), list(a.strings),
            None if a.t is None else (a.t.name, list(a.t.dims), a.t.data_type))


@pytest.mark.parametrize("case", list(PROTO_CASES))
def test_proto_reader_equals_jax(case):
    torch.manual_seed(0)
    blob = PROTO_CASES[case]()
    m, jm = proto.parse_model(blob), jproto.parse_model(blob)
    assert (m.ir_version, m.producer_name, m.opset) == (jm.ir_version, jm.producer_name, jm.opset)
    g, jg = m.graph, jm.graph
    assert [(n.op_type, n.name, list(n.inputs), list(n.outputs)) for n in g.nodes] == \
        [(n.op_type, n.name, list(n.inputs), list(n.outputs)) for n in jg.nodes]
    assert [{k: _attr(a) for k, a in n.attributes.items()} for n in g.nodes] == \
        [{k: _attr(a) for k, a in n.attributes.items()} for n in jg.nodes]
    assert [vi.name for vi in g.inputs] == [vi.name for vi in jg.inputs]
    assert [vi.name for vi in g.outputs] == [vi.name for vi in jg.outputs]
    assert [t.name for t in g.initializers] == [t.name for t in jg.initializers]
    for t, jt in zip(g.initializers, jg.initializers):
        a, b = proto.tensor_to_numpy(t), jproto.tensor_to_numpy(jt)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert proto.serialize_model(m) == jproto.serialize_model(jm)


# -------------------------------------------------------- codec and pipeline


def _codecs(d):
    from smalltts_tpu.onnxjax.codec import OnnxCodec as JOnnxCodec
    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec

    return (OnnxCodec(str(d / "encoder.onnx"), str(d / "decoder.onnx"), device="cpu"),
            JOnnxCodec(str(d / "encoder.onnx"), str(d / "decoder.onnx")))


def test_onnx_codec_equals_jax(mini_assets):
    """encode and decode against the JAX OnnxCodec and the torch modules
    (3e-5 / 5e-5 absolute, the JAX test's tolerances)."""
    d, enc_t, dec_t = mini_assets
    codec, jcodec = _codecs(d)
    assert set(codec.params) == {"encoder", "decoder"}
    audio = np.random.RandomState(0).randn(2, 1, 6 * CODEC_HOP).astype(np.float32) * 0.3
    lat = codec.encode_fn(codec.params, torch.from_numpy(audio))
    assert lat.shape == (2, 6, LATENT)
    jlat = np.asarray(jax.jit(jcodec.encode_fn)(jcodec.params, audio))
    np.testing.assert_allclose(lat.numpy(), jlat, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(lat.numpy(), enc_t(torch.from_numpy(audio)).numpy(), atol=3e-5, rtol=1e-4)
    wav = codec.decode_fn(codec.params, lat)
    assert wav.shape == (2, 1, 6 * CODEC_HOP)
    jwav = np.asarray(jax.jit(jcodec.decode_fn)(jcodec.params, jlat))
    np.testing.assert_allclose(wav.numpy(), jwav, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(wav.numpy(), dec_t(lat).numpy(), atol=5e-5, rtol=1e-3)
    assert "Conv" in codec.describe() and codec.describe().count("\n") == 1


def test_onnx_codec_decoder_only(mini_assets):
    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec

    d, _, _ = mini_assets
    codec = OnnxCodec(None, str(d / "decoder.onnx"), device="cpu")
    assert codec.encoder is None and set(codec.params) == {"decoder"}
    assert codec.decode_fn(codec.params, torch.zeros((1, 4, LATENT))).shape == (1, 1, 4 * CODEC_HOP)
    with pytest.raises(ValueError, match="without an encoder"):
        codec.encode_fn(codec.params, torch.zeros((1, 1, CODEC_HOP)))
    with pytest.raises(ValueError, match="at least one"):
        OnnxCodec(None, None, device="cpu")


@pytest.fixture(scope="module")
def weights():
    from smalltts_tpu.models.backbone import init_backbone as j_init_backbone
    from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict
    from smalltts_tpu_torch.utils.convert import params_from_jax

    jp = j_init_backbone(jax.random.PRNGKey(0), TINY_BACKBONE)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE)))


def test_smalltts_with_onnx_codec_equals_jax(mini_assets, weights):
    """SmallTTS(codec=OnnxCodec): the waveform of one padded batch against
    the JAX pipeline's latents (same weights and noise) through the JAX
    OnnxCodec (1e-5 relative to the largest value); encode_reference goes
    through the ONNX encoder in both."""
    from smalltts_tpu.infer.pipeline import SmallTTS as JSmallTTS
    from smalltts_tpu.infer.sampler import sample_latents as j_sample_latents
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict

    d, _, _ = mini_assets
    jp, tp = weights
    codec, jcodec = _codecs(d)
    tts = SmallTTS(tp, cfg=backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE)),
                   codec_cfg=codec_config_from_dict(dataclasses.asdict(TINY_CODEC)), codec=codec, device="cpu")
    jtts = JSmallTTS(jp, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec=jcodec)
    assert tts.onnx_codec is codec and jtts.onnx_codec is jcodec
    b, r, p, t = 2, 32, 64, 16
    rs = np.random.RandomState(1)
    args = (rs.randn(b, r, LATENT).astype(np.float32), np.full((b,), 8, np.int32),
            rs.randint(1, 90, (b, p)).astype(np.int32), np.full((b,), 5, np.int32), np.full((b,), 12, np.int32))
    noises = rs.randn(4, b, t, LATENT).astype(np.float32)
    got = tts.synthesize_padded(*args, t, noises=noises)
    lat = j_sample_latents(jtts.params, TINY_BACKBONE, *(jnp.asarray(a) for a in args), jax.random.PRNGKey(0),
                           num_steps=4, noises=jnp.asarray(noises))
    want = np.asarray(jtts._decode_fn(jtts.codec_params, lat))
    assert got.shape == want.shape == (b, 1, t * CODEC_HOP)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() and np.abs(want).max() > 1e-3
    wave = rs.randn(3200).astype(np.float32)
    ref, jref = tts.encode_reference(wave), jtts.encode_reference(wave)
    assert ref.shape == jref.shape == (1, LATENT)
    np.testing.assert_allclose(ref, jref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("choice", ["auto_with_assets", "auto_without_assets", "onnx", "native",
                                    "auto_with_codec_weights", "bogus"])
def test_codec_choice_equals_jax(mini_assets, weights, tmp_path, monkeypatch, choice):
    """Which backend SmallTTS(codec=...) picks, against the JAX pipeline on
    the same $SMALLTTS_ASSETS: "auto" is the ONNX codec when the assets are
    present and no native codec weights were passed; an unknown name
    raises in both."""
    import shutil

    from smalltts_tpu.infer.pipeline import SmallTTS as JSmallTTS
    from smalltts_tpu.models.codec import init_codec as j_init_codec
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict
    from smalltts_tpu_torch.utils.convert import params_from_jax

    d, _, _ = mini_assets
    jp, tp = weights
    root = tmp_path / "assets"
    if choice in ("auto_with_assets", "onnx", "native", "auto_with_codec_weights"):
        (root / "codec").mkdir(parents=True)
        for f in ("encoder.onnx", "decoder.onnx"):
            shutil.copy(d / f, root / "codec" / f)
    monkeypatch.setenv("SMALLTTS_ASSETS", str(root))
    codec = choice.split("_with")[0].split("_without")[0]
    pcodec = codec_config_from_dict(dataclasses.asdict(TINY_CODEC))
    jc = tc = None
    if choice == "auto_with_codec_weights":
        jc = j_init_codec(jax.random.PRNGKey(1), TINY_CODEC)
        tc = params_from_jax(jax.tree.map(np.asarray, jc), pcodec)
    kw = dict(cfg=backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE)), codec_cfg=pcodec, codec=codec,
              device="cpu")
    if choice == "bogus":
        with pytest.raises(ValueError, match="codec must be"):
            SmallTTS(tp, **kw)
        with pytest.raises(ValueError, match="codec must be"):
            JSmallTTS(jp, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec=codec)
        return
    tts = SmallTTS(tp, tc, **kw)
    jtts = JSmallTTS(jp, jc, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec=codec)
    assert (tts.onnx_codec is None) == (jtts.onnx_codec is None)
    assert (tts.onnx_codec is None) == (choice in ("auto_without_assets", "native", "auto_with_codec_weights"))
    if tts.onnx_codec is not None:
        assert set(tts.codec_params) == set(jtts.codec_params) == {"encoder", "decoder"}


def test_onnx_import_utils(mini_assets):
    from smalltts_tpu.utils.onnx_import import describe_graph as j_describe
    from smalltts_tpu.utils.onnx_import import load_initializers as j_load
    from smalltts_tpu_torch.utils.onnx_import import describe_graph, load_initializers

    d, _, _ = mini_assets
    path = str(d / "encoder.onnx")
    inits, jinits = load_initializers(path), j_load(path)
    assert list(inits) == list(jinits) and any(v.ndim == 3 for v in inits.values())
    for k in inits:
        np.testing.assert_array_equal(inits[k], jinits[k])
    assert describe_graph(path) == j_describe(path) and "Conv" in describe_graph(path)


def test_imported_smalltts_equals_jax(mini_published):
    """The published-graph pipeline with injected noise against the JAX
    ImportedSmallTTS (2e-5 absolute, 1e-4 relative) and the noise-count
    check; fresh noise differs from call to call."""
    from smalltts_tpu.onnxjax.pipeline import ImportedSmallTTS as JImported
    from smalltts_tpu.onnxjax.pipeline import _rope_freqs as j_rope_freqs
    from smalltts_tpu_torch.onnxtorch.pipeline import ImportedSmallTTS, _rope_freqs

    d, _, _, _ = mini_published
    paths = [str(d / f) for f in ("condition_encoder.onnx", "denoiser.onnx", "decoder.onnx")]
    tts, jtts = ImportedSmallTTS(*paths, device="cpu"), JImported(*paths)
    np.testing.assert_array_equal(_rope_freqs(16), j_rope_freqs(16))
    rng = np.random.RandomState(0)
    ref = rng.randn(6, IMP_LAT).astype(np.float32)
    tokens = [3, 7, 9, 11, 2, 4, 8]
    duration = 2.2
    seq_len = int(duration * 24_000 / 3_200)
    noises = rng.randn(4, 1, seq_len, IMP_LAT).astype(np.float32)
    got = tts.synthesize(ref, tokens, duration, noises=noises)
    want = jtts.synthesize(ref, tokens, duration, noises=noises)
    assert got.shape == want.shape and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="steps"):
        tts.synthesize(ref, tokens, duration, noises=noises[:3])
    a, b = tts.synthesize(ref, tokens, 1.0), tts.synthesize(ref, tokens, 1.0)
    assert a.shape == b.shape and np.isfinite(a).all() and not np.allclose(a, b)


def test_imported_assets_present(tmp_path):
    from smalltts_tpu.onnxjax.pipeline import assets_present as j_assets_present
    from smalltts_tpu_torch.onnxtorch.pipeline import assets_present

    assert not assets_present(str(tmp_path)) and not j_assets_present(str(tmp_path))
    (tmp_path / "dmd").mkdir()
    (tmp_path / "codec").mkdir()
    for p in ("dmd/condition_encoder.onnx", "dmd/denoiser.onnx", "codec/decoder.onnx"):
        (tmp_path / p).write_bytes(b"x")
    assert assets_present(str(tmp_path)) and j_assets_present(str(tmp_path))


# ------------------------------------- the port's own models, exported and imported


@pytest.fixture(scope="module")
def own_models():
    """The port's tiny backbone (zero-init leaves redrawn) and codec, seeded."""
    from smalltts_tpu_torch.models.backbone import init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.codec import init_codec
    from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict

    cfg = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
    ccfg = codec_config_from_dict(dataclasses.asdict(TINY_CODEC))
    g = torch.Generator().manual_seed(0)
    return cfg, ccfg, redraw_zero_init(init_backbone(g, cfg), g), init_codec(g, ccfg)


def test_own_codec_exported_with_dynamic_axes_equals_native(own_models, tmp_path):
    """The native codec exported (onnxtorch.export) with dynamic batch and
    time axes, then OnnxCodec at another length: equal to the native
    codec within 1e-5 of the largest value."""
    from smalltts_tpu_torch.models.codec import codec_decode, codec_encode
    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec
    from smalltts_tpu_torch.onnxtorch.export import CodecDecoder, CodecEncoder, export as own_export

    _, ccfg, _, cp = own_models
    hop = ccfg.hop
    (tmp_path / "encoder.onnx").write_bytes(own_export(CodecEncoder(cp, ccfg), (0.1 * _rand(1, 1, 4 * hop),),
                                                       dynamic_axes={"audio": {0: "b", 2: "t"}},
                                                       input_names=["audio"]))
    (tmp_path / "decoder.onnx").write_bytes(own_export(CodecDecoder(cp, ccfg), (_rand(1, 4, 64),),
                                                       dynamic_axes={"latents": {0: "b", 1: "t"}},
                                                       input_names=["latents"]))
    codec = OnnxCodec(str(tmp_path / "encoder.onnx"), str(tmp_path / "decoder.onnx"), device="cpu")
    audio = 0.1 * _rand(2, 1, 6 * hop)
    lat = codec.encode_fn(codec.params, audio)
    want = codec_encode(cp, audio, ccfg)
    assert lat.shape == want.shape == (2, 6, 64) and float((lat - want).abs().max()) <= 1e-5 * float(want.abs().max())
    wav = codec.decode_fn(codec.params, want)
    want_wav = codec_decode(cp, want, ccfg)
    assert wav.shape == (2, 1, 6 * hop)
    assert float((wav - want_wav).abs().max()) <= 1e-5 * float(want_wav.abs().max())


def test_own_models_through_imported_smalltts(own_models, tmp_path):
    """The port's condition encoder, cached DiT step and codec decoder
    exported with the published positional contract (every denoiser input
    used), then ImportedSmallTTS with injected noise against the same
    recurrence over the torch modules: 1e-4 of the largest sample."""
    from smalltts_tpu_torch.onnxtorch.export import CodecDecoder, ConditionEncoder, Denoiser, export as own_export
    from smalltts_tpu_torch.onnxtorch.pipeline import ImportedSmallTTS, _rope_freqs
    from smalltts_tpu_torch.ops.schedule import get_alpha_sigma

    cfg, ccfg, bp, cp = own_models
    R, Pn, dur = 6, 7, 1.0
    S = int(dur * 24_000 / 3_200)
    cond, den, dec = ConditionEncoder(bp, cfg), Denoiser(bp, cfg), CodecDecoder(cp, ccfg)
    rng = np.random.RandomState(3)
    ref = rng.randn(R, 64).astype(np.float32)
    tokens = rng.randint(1, 90, Pn).tolist()
    cargs = (torch.from_numpy(ref[None]), torch.tensor([R]), torch.tensor([tokens]), torch.ones(1, Pn, dtype=torch.bool))
    with torch.no_grad():
        kv = cond(*cargs)
    dargs = (_rand(1, S, 64), torch.ones(1, S, dtype=torch.bool), torch.tensor([0.5]), *kv, cargs[3],
             torch.from_numpy(_rope_freqs(S)))
    paths = [tmp_path / f for f in ("condition_encoder.onnx", "denoiser.onnx", "decoder.onnx")]
    paths[0].write_bytes(own_export(cond, cargs))
    paths[1].write_bytes(own_export(den, dargs))
    paths[2].write_bytes(own_export(dec, (_rand(1, S, 64),)))
    tts = ImportedSmallTTS(*map(str, paths), device="cpu")
    assert len(tts.denoiser.input_names) == 10
    noises = rng.randn(4, 1, S, 64).astype(np.float32)
    got = tts.synthesize(ref, tokens, dur, noises=noises)
    with torch.no_grad():
        ts = torch.linspace(1.0, 0.0, 4)
        alphas, sigmas = get_alpha_sigma(ts)
        x = torch.zeros(1, S, 64)
        for i in range(4):
            x_t = alphas[i] * x + sigmas[i] * torch.from_numpy(noises[i])
            x = alphas[i] * x_t - sigmas[i] * den(x_t, dargs[1], ts[i:i + 1], *kv, cargs[3], dargs[-1])
        want = dec(x).numpy()[0]
    assert got.shape == want.shape == (1, S * ccfg.hop) and np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ------------------------------------------ one node of each op type against JAX


def _op_graph(op, ins, attrs=None, n_out=1, opset=17):
    """One node. `ins` in the node's input order: ("x", array) a graph input,
    ("c", array) an initializer, None an absent optional input."""
    names, graph_inputs, inits, feeds = [], [], [], []
    for i, item in enumerate(ins):
        if item is None:
            names.append("")
            continue
        kind, arr = item
        names.append(f"{kind}{i}")
        if kind == "x":
            graph_inputs.append(P.make_value_info(names[-1], 1, []))
            feeds.append(np.asarray(arr))
        else:
            inits.append(P.numpy_to_tensor(names[-1], np.asarray(arr)))
    outs = [f"y{j}" for j in range(n_out)]
    g = P.Graph(nodes=[P.Node(op_type=op, inputs=names, outputs=outs, attributes=dict(attrs or {}))],
                initializers=inits, inputs=graph_inputs, outputs=[P.make_value_info(o, 1, []) for o in outs])
    return P.serialize_model(P.Model(graph=g, opset={"": opset})), feeds


R0 = np.random.RandomState(7)
F32 = lambda *s: R0.randn(*s).astype(np.float32)  # noqa: E731
U = lambda *s: R0.uniform(-0.9, 0.9, s).astype(np.float32)  # noqa: E731
A = {"i": P.attr_i, "f": P.attr_f, "s": P.attr_s, "ints": P.attr_ints, "floats": P.attr_floats, "t": P.attr_t}


def _attrs(**kw):
    """attrs(axis=("i", 1), ...) -> {name: Attribute}."""
    return {k: A[kind](k, v) for k, (kind, v) in kw.items()}


X = ("x", F32(2, 3, 5))
UNARY = ["Exp", "Abs", "Neg", "Floor", "Ceil", "Round", "Sign", "Sin", "Cos", "Atan", "Sinh", "Cosh", "Tanh",
         "Asinh", "Erf", "Sigmoid", "Relu", "Softplus", "Softsign", "Mish", "IsNaN", "Identity", "HardSwish"]
OP_CASES = {f"{op}": (op, [X], None, 1, 17) for op in UNARY}
OP_CASES.update({
    "Sqrt": ("Sqrt", [("x", np.abs(F32(2, 5)) + 0.1)], None, 1, 17),
    "Log": ("Log", [("x", np.abs(F32(2, 5)) + 0.1)], None, 1, 17),
    "Reciprocal": ("Reciprocal", [("x", np.abs(F32(2, 5)) + 0.5)], None, 1, 17),
    "Tan_Asin_Acos_Atanh": ("Tan", [("x", U(3, 4))], None, 1, 17),
    "Asin": ("Asin", [("x", U(3, 4))], None, 1, 17),
    "Acos": ("Acos", [("x", U(3, 4))], None, 1, 17),
    "Atanh": ("Atanh", [("x", U(3, 4))], None, 1, 17),
    "Acosh": ("Acosh", [("x", np.abs(F32(3, 4)) + 1.5)], None, 1, 17),
    "Not": ("Not", [("x", F32(3, 4) > 0)], None, 1, 17),
    "LeakyRelu": ("LeakyRelu", [X], _attrs(alpha=("f", 0.3)), 1, 17),
    "Elu": ("Elu", [X], _attrs(alpha=("f", 0.7)), 1, 17),
    "Selu": ("Selu", [X], None, 1, 17),
    "Celu": ("Celu", [X], _attrs(alpha=("f", 1.5)), 1, 17),
    "HardSigmoid": ("HardSigmoid", [X], _attrs(alpha=("f", 0.3), beta=("f", 0.4)), 1, 17),
    "Gelu_none": ("Gelu", [X], None, 1, 20),
    "Gelu_tanh": ("Gelu", [X], _attrs(approximate=("s", "tanh")), 1, 20),
    "Add_broadcast": ("Add", [X, ("x", F32(3, 1))], None, 1, 17),
    "Sub_const": ("Sub", [X, ("c", F32(5))], None, 1, 17),
    "Mul": ("Mul", [X, ("x", F32(2, 3, 5))], None, 1, 17),
    "Div_float": ("Div", [X, ("x", np.abs(F32(5)) + 0.5)], None, 1, 17),
    "Div_int_truncates": ("Div", [("x", np.array([-7, 7, -8, 9], np.int64)), ("x", np.array([2, -2, 3, 4], np.int64))],
                          None, 1, 17),
    "Pow": ("Pow", [("x", np.abs(F32(3, 4)) + 0.1), ("x", F32(3, 4))], None, 1, 17),
    "And": ("And", [("x", F32(3, 4) > 0), ("x", F32(3, 4) > 0)], None, 1, 17),
    "Or": ("Or", [("x", F32(3, 4) > 0), ("x", F32(3, 4) > 0)], None, 1, 17),
    "Xor": ("Xor", [("x", F32(3, 4) > 0), ("x", F32(3, 4) > 0)], None, 1, 17),
    "Equal": ("Equal", [("x", np.array([1, 2, 3], np.int64)), ("x", np.array([1, 0, 3], np.int64))], None, 1, 17),
    "Greater": ("Greater", [X, ("c", np.float32(0.1))], None, 1, 17),
    "GreaterOrEqual": ("GreaterOrEqual", [X, ("x", F32(2, 3, 5))], None, 1, 17),
    "Less": ("Less", [X, ("x", F32(5))], None, 1, 17),
    "LessOrEqual": ("LessOrEqual", [X, ("x", F32(5))], None, 1, 17),
    "Where": ("Where", [("x", F32(2, 3, 5) > 0), X, ("x", F32(3, 5))], None, 1, 17),
    "Min3": ("Min", [X, ("x", F32(3, 5)), ("x", F32(5))], None, 1, 17),
    "Max3": ("Max", [X, ("x", F32(3, 5)), ("x", F32(5))], None, 1, 17),
    "Sum3": ("Sum", [X, ("x", F32(3, 5)), ("x", F32(5))], None, 1, 17),
    "Mean3": ("Mean", [X, ("x", F32(3, 5)), ("x", F32(5))], None, 1, 17),
    "PRelu": ("PRelu", [X, ("c", F32(3, 1))], None, 1, 17),
    "Mod_int": ("Mod", [("x", np.array([-7, 7, -8, 9], np.int64)), ("x", np.array([3, -3, 5, 4], np.int64))],
                None, 1, 17),
    "Mod_fmod": ("Mod", [("x", F32(3, 4) * 5), ("x", np.full((3, 4), 1.5, np.float32))], _attrs(fmod=("i", 1)), 1,
                 17),
    "Clip_inputs": ("Clip", [X, ("c", np.float32(-0.5)), ("c", np.float32(0.7))], None, 1, 17),
    "Clip_min_only": ("Clip", [X, ("c", np.float32(-0.5)), None], None, 1, 17),
    "Clip_opset6_attrs": ("Clip", [X], _attrs(min=("f", -0.2), max=("f", 0.3)), 1, 6),
    "Cast_to_int": ("Cast", [("x", F32(3, 4) * 4)], _attrs(to=("i", 7)), 1, 17),
    "CastLike": ("CastLike", [("x", F32(3, 4) * 4), ("x", np.zeros(1, np.int32))], None, 1, 17),
    "Dropout_with_mask": ("Dropout", [X], None, 2, 17),
    "ReduceSum_axes_input": ("ReduceSum", [X, ("c", np.array([1, -1], np.int64))], _attrs(keepdims=("i", 0)), 1, 17),
    "ReduceSum_noop_empty": ("ReduceSum", [X, ("c", np.zeros(0, np.int64))],
                             _attrs(noop_with_empty_axes=("i", 1)), 1, 17),
    "ReduceMean": ("ReduceMean", [X], _attrs(axes=("ints", [1])), 1, 17),
    "ReduceMax_all": ("ReduceMax", [X], _attrs(keepdims=("i", 0)), 1, 17),
    "ReduceMin": ("ReduceMin", [X], _attrs(axes=("ints", [0, 2])), 1, 17),
    "ReduceProd": ("ReduceProd", [X], _attrs(axes=("ints", [0, 2]), keepdims=("i", 0)), 1, 17),
    "ReduceL1": ("ReduceL1", [X], _attrs(axes=("ints", [2])), 1, 17),
    "ReduceL2": ("ReduceL2", [X], _attrs(axes=("ints", [2])), 1, 17),
    "ReduceSumSquare": ("ReduceSumSquare", [X], _attrs(axes=("ints", [1])), 1, 17),
    "ReduceLogSum": ("ReduceLogSum", [("x", np.abs(F32(2, 3, 5)) + 0.1)], _attrs(axes=("ints", [1])), 1, 17),
    "ReduceLogSumExp": ("ReduceLogSumExp", [X], _attrs(axes=("ints", [2])), 1, 17),
    "ReduceMean_opset18_input": ("ReduceMean", [X, ("c", np.array([0], np.int64))], None, 1, 18),
    "ArgMin": ("ArgMin", [X], _attrs(axis=("i", 2)), 1, 17),
    "CumSum": ("CumSum", [X, ("c", np.array(2, np.int64))], None, 1, 17),
    "CumSum_exclusive_reverse": ("CumSum", [X, ("c", np.array(1, np.int64))],
                                 _attrs(exclusive=("i", 1), reverse=("i", 1)), 1, 17),
    "Shape_start_end": ("Shape", [X], _attrs(start=("i", 1), end=("i", -1)), 1, 17),
    "Size": ("Size", [X], None, 1, 17),
    "ConstantOfShape": ("ConstantOfShape", [("c", np.array([2, 3], np.int64))],
                        _attrs(value=("t", np.array([1.5], np.float32))), 1, 17),
    "Range": ("Range", [("c", np.array(1, np.int64)), ("c", np.array(10, np.int64)), ("c", np.array(3, np.int64))],
              None, 1, 17),
    "Squeeze_axes": ("Squeeze", [("x", F32(1, 3, 1, 2)), ("c", np.array([0, 2], np.int64))], None, 1, 17),
    "Squeeze_all": ("Squeeze", [("x", F32(1, 3, 1, 2))], None, 1, 17),
    "Squeeze_opset11": ("Squeeze", [("x", F32(1, 3, 1, 2))], _attrs(axes=("ints", [2])), 1, 11),
    "Unsqueeze_negative": ("Unsqueeze", [X, ("c", np.array([-1, 0], np.int64))], None, 1, 17),
    "Unsqueeze_opset11": ("Unsqueeze", [X], _attrs(axes=("ints", [1])), 1, 11),
    "Transpose_default": ("Transpose", [X], None, 1, 17),
    "Split_input": ("Split", [("x", F32(2, 7)), ("c", np.array([3, 4], np.int64))], _attrs(axis=("i", 1)), 2, 17),
    "Split_even": ("Split", [("x", F32(6, 2))], None, 3, 17),
    "Split_num_outputs": ("Split", [("x", F32(2, 7))], _attrs(axis=("i", 1), num_outputs=("i", 2)), 2, 18),
    "Slice_negative_step": ("Slice", [("x", F32(4, 9)), ("c", np.array([-1, 7], np.int64)),
                                      ("c", np.array([-(1 << 63), 1], np.int64)), ("c", np.array([0, 1], np.int64)),
                                      ("c", np.array([-2, -3], np.int64))], None, 1, 17),
    "Slice_opset9_attrs": ("Slice", [("x", F32(4, 9))], _attrs(starts=("ints", [1]), ends=("ints", [3]),
                                                                 axes=("ints", [1])), 1, 9),
    "Gather_axis1_negative": ("Gather", [X, ("c", np.array([[0, -1], [2, 1]], np.int64))], _attrs(axis=("i", 1)), 1,
                              17),
    "GatherElements": ("GatherElements", [X, ("c", R0.randint(-5, 5, (2, 3, 2)).astype(np.int64))],
                       _attrs(axis=("i", 2)), 1, 17),
    "ScatterElements": ("ScatterElements", [X, ("c", np.array([[[0, 4]]] * 3).reshape(1, 3, 2).repeat(2, 0)),
                                            ("x", F32(2, 3, 2))], _attrs(axis=("i", 2)), 1, 17),
    "ScatterElements_add": ("ScatterElements", [X, ("c", np.array([[[1, 1]]]).repeat(3, 1).repeat(2, 0)),
                                                ("x", F32(2, 3, 2))], _attrs(axis=("i", 2), reduction=("s", "add")),
                            1, 17),
    "Expand_rank_up": ("Expand", [("x", F32(3, 1)), ("c", np.array([2, 1, 4], np.int64))], None, 1, 17),
    "Tile": ("Tile", [("x", F32(2, 3)), ("c", np.array([2, 3], np.int64))], None, 1, 17),
    "Pad_reflect": ("Pad", [X, ("c", np.array([0, 0, 2, 0, 0, 3], np.int64))], _attrs(mode=("s", "reflect")), 1, 17),
    "Pad_edge": ("Pad", [X, ("c", np.array([0, 1, 2, 0, 2, 1], np.int64))], _attrs(mode=("s", "edge")), 1, 17),
    "Pad_wrap": ("Pad", [X, ("c", np.array([0, 0, 2, 0, 0, 1], np.int64))], _attrs(mode=("s", "wrap")), 1, 19),
    "Pad_negative_constant": ("Pad", [X, ("c", np.array([0, -1, 2, 0, 0, -1], np.int64)),
                                      ("c", np.float32(0.25))], None, 1, 17),
    "Pad_axes": ("Pad", [X, ("c", np.array([1, 2], np.int64)), None, ("c", np.array([-1], np.int64))], None, 1, 18),
    "Pad_opset2_attrs": ("Pad", [X], _attrs(pads=("ints", [0, 1, 0, 0, 1, 0]), value=("f", 2.0)), 1, 2),
    "DepthToSpace_DCR": ("DepthToSpace", [("x", F32(1, 8, 2, 3))], _attrs(blocksize=("i", 2)), 1, 17),
    "DepthToSpace_CRD": ("DepthToSpace", [("x", F32(1, 8, 2, 3))], _attrs(blocksize=("i", 2), mode=("s", "CRD")), 1,
                         17),
    "SpaceToDepth": ("SpaceToDepth", [("x", F32(1, 2, 4, 6))], _attrs(blocksize=("i", 2)), 1, 17),
    "Trilu_upper_k1": ("Trilu", [("x", F32(2, 4, 5)), ("c", np.array(1, np.int64))], None, 1, 17),
    "Trilu_lower": ("Trilu", [("x", F32(4, 5))], _attrs(upper=("i", 0)), 1, 17),
    "OneHot_axis0": ("OneHot", [("x", np.array([[0, 2], [1, -1]], np.int64)), ("c", np.array(3, np.int64)),
                                ("c", np.array([-1.0, 2.0], np.float32))], _attrs(axis=("i", 0)), 1, 17),
    "MatMul_batched": ("MatMul", [("x", F32(2, 3, 4)), ("x", F32(4, 5))], None, 1, 17),
    "Gemm_transposes": ("Gemm", [("x", F32(4, 3)), ("x", F32(5, 4)), ("c", F32(5))],
                        _attrs(transA=("i", 1), transB=("i", 1), alpha=("f", 0.5), beta=("f", 2.0)), 1, 17),
    "Gemm_plain": ("Gemm", [("x", F32(3, 4)), ("c", F32(4, 5))], None, 1, 17),
    "Einsum": ("Einsum", [("x", F32(2, 3, 4)), ("x", F32(2, 4, 5))], _attrs(equation=("s", "bij,bjk->bik")), 1, 17),
    "Softmax_opset11_coerces": ("Softmax", [X], _attrs(axis=("i", 1)), 1, 11),
    "Softmax": ("Softmax", [X], None, 1, 17),
    "LogSoftmax": ("LogSoftmax", [X], _attrs(axis=("i", 1)), 1, 17),
    "LayerNorm_three_outputs": ("LayerNormalization", [X, ("c", F32(3, 5)), ("c", F32(3, 5))],
                                _attrs(axis=("i", 1), epsilon=("f", 1e-3)), 3, 17),
    "InstanceNorm": ("InstanceNormalization", [("x", F32(2, 3, 6)), ("c", F32(3)), ("c", F32(3))], None, 1, 17),
    "GroupNorm_per_group": ("GroupNormalization", [("x", F32(2, 6, 5)), ("c", F32(2)), ("c", F32(2))],
                            _attrs(num_groups=("i", 2)), 1, 18),
    "BatchNorm": ("BatchNormalization", [("x", F32(2, 3, 6)), ("c", F32(3)), ("c", F32(3)), ("c", F32(3)),
                                         ("c", np.abs(F32(3)) + 0.5)], None, 1, 17),
    "LpNorm_p1": ("LpNormalization", [X], _attrs(p=("i", 1), axis=("i", 1)), 1, 17),
    "LpNorm_p2": ("LpNormalization", [X], None, 1, 17),
    "Conv_same_upper_strided": ("Conv", [("x", F32(1, 2, 9)), ("c", F32(4, 2, 4))],
                                _attrs(auto_pad=("s", "SAME_UPPER"), strides=("ints", [2])), 1, 17),
    "Conv_asymmetric_pads": ("Conv", [("x", F32(1, 2, 9)), ("c", F32(4, 2, 3)), ("c", F32(4))],
                             _attrs(pads=("ints", [2, 0]), dilations=("ints", [2])), 1, 17),
    "Conv2d_groups": ("Conv", [("x", F32(1, 4, 5, 6)), ("c", F32(4, 2, 3, 3))],
                      _attrs(group=("i", 2), pads=("ints", [1, 0, 1, 2])), 1, 17),
    "ConvTranspose_asymmetric": ("ConvTranspose", [("x", F32(1, 3, 5)), ("c", F32(3, 2, 4)), ("c", F32(2))],
                                 _attrs(strides=("ints", [2]), pads=("ints", [1, 2])), 1, 17),
    "ConvTranspose_same_upper": ("ConvTranspose", [("x", F32(1, 3, 5)), ("c", F32(3, 2, 3))],
                                 _attrs(strides=("ints", [2]), auto_pad=("s", "SAME_UPPER")), 1, 17),
    "ConvTranspose_output_padding": ("ConvTranspose", [("x", F32(1, 3, 5)), ("c", F32(3, 2, 3))],
                                     _attrs(strides=("ints", [2]), output_padding=("ints", [1])), 1, 17),
    "GlobalAveragePool": ("GlobalAveragePool", [("x", F32(2, 3, 4, 5))], None, 1, 17),
    "GlobalMaxPool": ("GlobalMaxPool", [("x", F32(2, 3, 4, 5))], None, 1, 17),
    "MaxPool_ceil_dilated": ("MaxPool", [("x", F32(1, 2, 11))], _attrs(kernel_shape=("ints", [3]), strides=("ints", [2]),
                                                                         dilations=("ints", [2]), ceil_mode=("i", 1),
                                                                         pads=("ints", [1, 1])), 1, 17),
    "MaxPool2d_same": ("MaxPool", [("x", F32(1, 2, 5, 6))], _attrs(kernel_shape=("ints", [2, 3]),
                                                                    auto_pad=("s", "SAME_LOWER")), 1, 17),
    "AveragePool_include_pad": ("AveragePool", [("x", F32(1, 2, 9))], _attrs(
        kernel_shape=("ints", [3]), strides=("ints", [2]), pads=("ints", [1, 1]), count_include_pad=("i", 1)), 1, 17),
    "AveragePool_exclude_pad_ceil": ("AveragePool", [("x", F32(1, 2, 10))], _attrs(
        kernel_shape=("ints", [3]), strides=("ints", [2]), pads=("ints", [1, 0]), ceil_mode=("i", 1)), 1, 17),
    "Resize_nearest_sizes": ("Resize", [("x", F32(1, 2, 5)), None, None, ("c", np.array([1, 2, 8], np.int64))],
                             _attrs(nearest_mode=("s", "floor"), coordinate_transformation_mode=("s", "asymmetric")),
                             1, 17),
    "Resize_nearest_round_ceil": ("Resize", [("x", F32(1, 2, 6)), None, ("c", np.array([1, 1, 1.5], np.float32))],
                                  _attrs(nearest_mode=("s", "round_prefer_ceil")), 1, 17),
    "Resize_linear_align_corners": ("Resize", [("x", F32(1, 2, 4, 5)), None,
                                               ("c", np.array([1, 1, 2, 0.6], np.float32))],
                                    _attrs(mode=("s", "linear"),
                                           coordinate_transformation_mode=("s", "align_corners")), 1, 17),
    "Resize_linear_pytorch_half_pixel": ("Resize", [("x", F32(1, 2, 5)), None,
                                                    ("c", np.array([1, 1, 3], np.float32))],
                                         _attrs(mode=("s", "linear"),
                                                coordinate_transformation_mode=("s", "pytorch_half_pixel")), 1, 17),
    "Upsample_nearest": ("Upsample", [("x", F32(1, 2, 3, 4)), ("c", np.array([1, 1, 2, 2], np.float32))], None, 1, 9),
    "LSTM_initial_states": ("LSTM", [("x", F32(4, 2, 3)), ("c", F32(1, 8, 3)), ("c", F32(1, 8, 2)), ("c", F32(1, 16)),
                                     None, ("x", F32(1, 2, 2)), ("x", F32(1, 2, 2))],
                            _attrs(hidden_size=("i", 2)), 3, 17),
    "LSTM_reverse": ("LSTM", [("x", F32(4, 2, 3)), ("c", F32(1, 8, 3)), ("c", F32(1, 8, 2))],
                     _attrs(hidden_size=("i", 2), direction=("s", "reverse")), 3, 17),
    "GRU_linear_before_reset": ("GRU", [("x", F32(4, 2, 3)), ("c", F32(1, 6, 3)), ("c", F32(1, 6, 2)),
                                        ("c", F32(1, 12))],
                                _attrs(hidden_size=("i", 2), linear_before_reset=("i", 1)), 2, 17),
})


@pytest.mark.parametrize("case", list(OP_CASES))
def test_single_op_equals_jax(case):
    """One node of each op type and opset form, on random inputs, through
    the port's and the JAX package's interpreters: 1e-5 absolute + 1e-5
    relative (transcendental functions of two libraries), integers and
    booleans equal; integral outputs stay integral."""
    op_type, ins, attrs, n_out, opset = OP_CASES[case]
    blob, feeds = _op_graph(op_type, ins, attrs, n_out, opset)
    fn = OnnxFunction(parse_model(blob))
    got = fn(fn.params, *[torch.from_numpy(np.array(f)) for f in feeds])
    jfn = JOnnxFunction(j_parse_model(blob))
    want = jax.jit(jfn)(jfn.params, *[jnp.asarray(f) for f in feeds])
    gots = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    assert len(gots) == len(wants) == n_out
    for g, w in zip(gots, wants):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert np.issubdtype(g.dtype, np.floating) == np.issubdtype(w.dtype, np.floating)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))

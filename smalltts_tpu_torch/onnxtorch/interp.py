"""Graph-walking ONNX interpreter over PyTorch (port of
smalltts_tpu/onnxjax/interp.py, with the same op vocabulary).

Evaluates an ONNX graph node by node (ONNX graphs are topologically sorted
per spec) as `fn(params, *inputs)`:

* initializers become a params dict of tensors (cast, moved to the card,
  like any parameter tree); a host numpy copy of each is kept for the
  inputs that must be static (shape tensors);
* values flow as either `np.ndarray` (constants) or tensors (data). A node
  whose inputs are all numpy is folded on the host, so shape-math chains
  (`Shape -> Gather -> Concat -> Reshape`) stay static: `Shape` of a tensor
  is its shape as numpy. The data-movement ops whose extra inputs are shape
  tensors (Reshape, Slice, Pad, the Reduce family, ...) fold when their data
  input is numpy, as in the JAX interpreter under jit;
* a numpy constant that meets a tensor is copied to the tensor's device once
  per node, input and call signature (the graph inputs' shapes, dtypes and
  devices), and the copy is reused: a graph runs under CUDA-graph capture
  after one eager run at the same signature, with no host-to-device copy
  and no host sync in it. No op reads data back to the host;
* opset differences are handled per op (attribute -> input migrations for
  Slice/Squeeze/Unsqueeze/Pad/Clip/Reduce*, Softmax axis semantics);
* every call runs with TF32 off for matmul and for cuDNN: fp32 products are
  fp32, as the JAX package computes them under
  default_matmul_precision("highest").

`MatMul`, `Gemm` and `Conv` are `torch.matmul`, `F.linear` and
`F.conv1d/2d/3d`: the JAX package lowers them to XLA ops, not to a kernel of
its own.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from smalltts_tpu_torch.onnxtorch import proto
from smalltts_tpu_torch.onnxtorch.proto import Model, Node, tensor_to_numpy

_REGISTRY: Dict[str, Callable] = {}
# ops that fold when their data inputs (these positions) are numpy: the other
# inputs are shape tensors read through Ctx.static_input
_FOLD_ON: Dict[str, tuple] = {}


def op(name: str, fold_on: Optional[tuple] = None):
    def deco(fn):
        _REGISTRY[name] = fn
        if fold_on is not None:
            _FOLD_ON[name] = fold_on
        return fn

    return deco


def _is_const(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def to_tensor(v) -> torch.Tensor:
    """A numpy value as a CPU tensor of the same shape (a copy where the
    array is not contiguous or not writable)."""
    a = np.asarray(v)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy(order="C")
    return torch.from_numpy(a)


def to_static(v, what: str = "value") -> np.ndarray:
    if _is_const(v):
        return np.asarray(v)
    raise ValueError(
        f"ONNX import: {what} must be statically known (got a tensor); "
        "the graph does data-dependent shape computation the interpreter cannot fold")


def torch_dtype(np_dtype) -> torch.dtype:
    return to_tensor(np.zeros((0,), np_dtype)).dtype


@contextlib.contextmanager
def highest_precision():
    """fp32 matmuls and cuDNN convolutions without TF32, restored after."""
    prev = torch.get_float32_matmul_precision()
    if prev != "highest":
        torch.set_float32_matmul_precision("highest")
    from smalltts_tpu_torch.ops.nn import no_tf32

    try:
        with no_tf32():
            yield
    finally:
        if prev != "highest":
            torch.set_float32_matmul_precision(prev)


class Ctx:
    """Per-node evaluation context handed to op implementations."""

    def __init__(self, node: Node, opset: int, env: dict, statics: dict, base_dir: str, index: int,
                 cache: dict, sig: tuple):
        self.node = node
        self.opset = opset
        self._env = env
        self._statics = statics
        self.attrs = node.attributes
        self.base_dir = base_dir
        self._index = index
        self._cache = cache
        self._sig = sig

    # ---- attribute accessors
    def attr_i(self, name: str, default: Optional[int] = None) -> Optional[int]:
        a = self.attrs.get(name)
        return int(a.i) if a is not None else default

    def attr_f(self, name: str, default: Optional[float] = None) -> Optional[float]:
        a = self.attrs.get(name)
        return float(a.f) if a is not None else default

    def attr_s(self, name: str, default: str = "") -> str:
        a = self.attrs.get(name)
        return a.s.decode("utf-8") if a is not None else default

    def attr_ints(self, name: str, default=None):
        a = self.attrs.get(name)
        return list(a.ints) if a is not None else default

    def attr_floats(self, name: str, default=None):
        a = self.attrs.get(name)
        return list(a.floats) if a is not None else default

    def attr_tensor(self, name: str):
        # external data resolves against the model's directory, not the cwd
        a = self.attrs.get(name)
        return tensor_to_numpy(a.t, self.base_dir) if a is not None else None

    # ---- optional-input accessor (ONNX marks absent inputs with "")
    def input(self, idx: int):
        names = self.node.inputs
        if idx >= len(names) or names[idx] == "":
            return None
        return self._env[names[idx]]

    def static_input(self, idx: int):
        """Input that must be a constant (shape math). An initializer arrives
        as a tensor, but its value is the host copy bit for bit (exporters
        store Reshape/Slice/Pad shape tensors as initializers)."""
        v = self.input(idx)
        if v is None:
            return None
        name = self.node.inputs[idx]
        if isinstance(v, torch.Tensor) and name in self._statics:
            return np.asarray(self._statics[name])
        return to_static(v, f"{self.node.op_type} input #{idx}")

    def const(self, value, device, tag: str = "") -> torch.Tensor:
        """A numpy constant as a tensor on `device`: copied once per node,
        tag and call signature, then reused."""
        key = (self._index, tag, str(device), self._sig)
        t = self._cache.get(key)
        if t is None:
            t = self._cache[key] = to_tensor(value).to(device)
        return t


class OnnxFunction:
    """An ONNX model as a function of PyTorch tensors.

    `params` is `{initializer_name: tensor}` on the CPU (move it to the card
    with the rest of a model's parameters); `__call__(params, *inputs)`
    returns a single output or a tuple. Graph inputs are positional in the
    order declared by the model (minus initializers, which older exporters
    also list as graph inputs). numpy inputs and params become tensors.
    """

    def __init__(self, model: Model, base_dir: Optional[str] = None):
        # external data resolves against the directory the model was loaded
        # from (Model._path), never the cwd
        if base_dir is None:
            p = getattr(model, "_path", None)
            base_dir = os.path.dirname(os.path.abspath(p)) if p else "."
        self._base_dir = base_dir
        self.model = model
        self.opset = model.opset_version
        g = model.graph
        self._statics: Dict[str, np.ndarray] = {t.name: tensor_to_numpy(t, base_dir) for t in g.initializers}
        self.params: Dict[str, torch.Tensor] = {k: to_tensor(v) for k, v in self._statics.items()}
        self.input_names = [vi.name for vi in g.inputs if vi.name not in self.params]
        self.output_names = [vi.name for vi in g.outputs]
        self.input_info = {vi.name: vi for vi in g.inputs}
        # names whose values something reads: node inputs + graph outputs
        self._consumed = {i for n in g.nodes for i in n.inputs if i}
        self._consumed.update(self.output_names)
        self._cache: dict = {}
        unsupported = sorted({n.op_type for n in g.nodes if n.op_type not in _REGISTRY})
        if unsupported:
            raise NotImplementedError(
                f"ONNX import: unsupported ops {unsupported} (graph {g.name!r}, {len(g.nodes)} nodes)")
        # structural validation: a truncated file can still parse
        if not g.outputs:
            raise ValueError("ONNX import: graph has no outputs (truncated file?)")
        known = set(self.params) | set(self.input_names) | {""}
        for node in g.nodes:
            missing = [i for i in node.inputs if i not in known]
            if missing:
                raise ValueError(
                    f"ONNX import: node {node.op_type} ({node.name!r}) reads undefined values {missing} "
                    "(truncated or out-of-order graph)")
            known.update(node.outputs)
        dangling = [o for o in self.output_names if o not in known]
        if dangling:
            raise ValueError(f"ONNX import: graph outputs {dangling} are never produced (truncated file?)")

    def __call__(self, params: Dict[str, torch.Tensor], *inputs):
        if len(inputs) != len(self.input_names):
            raise ValueError(f"expected {len(self.input_names)} inputs {self.input_names}, got {len(inputs)}")
        inputs = [x if isinstance(x, torch.Tensor) else to_tensor(x) for x in inputs]
        sig = tuple((tuple(x.shape), x.dtype, str(x.device)) for x in inputs)
        env: Dict[str, object] = {k: v if isinstance(v, torch.Tensor) else to_tensor(v) for k, v in params.items()}
        env.update(zip(self.input_names, inputs))
        env[""] = None
        with highest_precision():
            for index, node in enumerate(self.model.graph.nodes):
                out = self._run_node(index, node, env, sig)
                for name, val in zip(node.outputs, out):
                    if name:
                        env[name] = val
                # a declared output the impl does not produce fails here, not
                # as a KeyError in a later node (unconsumed ones are fine)
                for name in node.outputs[len(out):]:
                    if name and name in self._consumed:
                        raise NotImplementedError(
                            f"{node.op_type}: declared output {name!r} is consumed by the graph but not implemented")
        outs = tuple(env[name] for name in self.output_names)
        return outs[0] if len(outs) == 1 else outs

    def _run_node(self, index, node, env, sig) -> tuple:
        fn = _REGISTRY[node.op_type]
        ctx = Ctx(node, self.opset, env, self._statics, self._base_dir, index, self._cache, sig)
        args = [env[name] if name else None for name in node.inputs]
        fold_on = _FOLD_ON.get(node.op_type)
        if all(a is None or _is_const(a) for a in args) or (
                fold_on is not None and args and all(_is_const(args[i]) for i in fold_on if i < len(args))):
            # folded on the host: numpy in, numpy out
            out = fn(ctx, *[to_tensor(a) if _is_const(a) else a for a in args])
            out = out if isinstance(out, tuple) else (out,)
            return tuple(o.numpy() if isinstance(o, torch.Tensor) else (None if o is None else np.asarray(o))
                         for o in out)
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        args = [ctx.const(a, device, f"in{i}") if _is_const(a) else a for i, a in enumerate(args)]
        out = fn(ctx, *args)
        return out if isinstance(out, tuple) else (out,)

    def ops_used(self) -> List[str]:
        return sorted({n.op_type for n in self.model.graph.nodes})


# ============================================================ elementwise


def _ew(name: str, fn):
    @op(name)
    def impl(ctx, *xs, _fn=fn):
        return _fn(*xs)

    return impl


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point()


def _div(a, b):
    if _is_float(a):
        return torch.div(a, b)
    # ONNX integer Div truncates toward zero (C semantics)
    return torch.div(a, b.to(a.dtype), rounding_mode="trunc")


def _pow(a, b):
    # the output takes the base dtype, but a fractional exponent must not be
    # truncated when the base is integer (pow(4, 0.5) == 2)
    if not _is_float(a) and _is_float(b):
        return torch.pow(a.to(b.dtype), b).to(a.dtype)
    return torch.pow(a, b.to(a.dtype))


def _variadic(fn, xs):
    out = xs[0]
    for x in xs[1:]:
        out = fn(out, x)
    return out


_ew("Add", torch.add)
_ew("Sub", torch.sub)
_ew("Mul", torch.mul)
_ew("Div", _div)
_ew("Pow", _pow)
_ew("Sqrt", torch.sqrt)
_ew("Exp", torch.exp)
_ew("Log", torch.log)
_ew("Abs", torch.abs)
_ew("Neg", torch.neg)
_ew("Floor", torch.floor)
_ew("Ceil", torch.ceil)
_ew("Round", torch.round)  # half to even, as jnp.round
_ew("Reciprocal", lambda x: 1.0 / x)
_ew("Sign", torch.sign)
_ew("Sin", torch.sin)
_ew("Cos", torch.cos)
_ew("Tan", torch.tan)
_ew("Asin", torch.asin)
_ew("Acos", torch.acos)
_ew("Atan", torch.atan)
_ew("Sinh", torch.sinh)
_ew("Cosh", torch.cosh)
_ew("Tanh", torch.tanh)
_ew("Asinh", torch.asinh)
_ew("Acosh", torch.acosh)
_ew("Atanh", torch.atanh)
_ew("Erf", torch.erf)
_ew("Sigmoid", torch.sigmoid)
_ew("Relu", torch.relu)
_ew("Softplus", F.softplus)
_ew("Softsign", lambda x: x / (1 + torch.abs(x)))
_ew("Mish", lambda x: x * torch.tanh(F.softplus(x)))
_ew("Not", torch.logical_not)
_ew("And", torch.logical_and)
_ew("Or", torch.logical_or)
_ew("Xor", torch.logical_xor)
_ew("Equal", torch.eq)
_ew("Greater", torch.gt)
_ew("GreaterOrEqual", torch.ge)
_ew("Less", torch.lt)
_ew("LessOrEqual", torch.le)
_ew("IsNaN", torch.isnan)
_ew("Where", torch.where)
_ew("Min", lambda *xs: _variadic(torch.minimum, xs))
_ew("Max", lambda *xs: _variadic(torch.maximum, xs))
_ew("Sum", lambda *xs: _variadic(torch.add, xs))
_ew("Mean", lambda *xs: _variadic(torch.add, xs) / len(xs))


@op("LeakyRelu")
def _leaky_relu(ctx, x):
    return F.leaky_relu(x, ctx.attr_f("alpha", 0.01))


@op("PRelu")
def _prelu(ctx, x, slope):
    return torch.where(x >= 0, x, x * slope)


@op("Elu")
def _elu(ctx, x):
    return F.elu(x, ctx.attr_f("alpha", 1.0))


@op("Selu")
def _selu(ctx, x):
    alpha = ctx.attr_f("alpha", 1.6732631921768188)
    gamma = ctx.attr_f("gamma", 1.0507010221481323)
    return gamma * torch.where(x > 0, x, alpha * torch.expm1(x))


@op("Celu")
def _celu(ctx, x):
    return F.celu(x, ctx.attr_f("alpha", 1.0))


@op("HardSigmoid")
def _hard_sigmoid(ctx, x):
    return torch.clamp(ctx.attr_f("alpha", 0.2) * x + ctx.attr_f("beta", 0.5), 0.0, 1.0)


@op("HardSwish")
def _hard_swish(ctx, x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


@op("Gelu")
def _gelu(ctx, x):
    return F.gelu(x, approximate="tanh" if ctx.attr_s("approximate", "none") == "tanh" else "none")


@op("Clip")
def _clip(ctx, x, *rest):
    if ctx.opset < 11:
        lo = ctx.attr_f("min", -3.4028234663852886e38)
        hi = ctx.attr_f("max", 3.4028234663852886e38)
        return torch.clamp(x, lo, hi)
    out = x
    if len(rest) > 0 and rest[0] is not None:
        out = torch.maximum(out, rest[0].to(x.dtype))
    if len(rest) > 1 and rest[1] is not None:
        out = torch.minimum(out, rest[1].to(x.dtype))
    return out


@op("Mod")
def _mod(ctx, a, b):
    if ctx.attr_i("fmod", 0):
        return torch.fmod(a, b)
    return torch.remainder(a, b)


@op("Cast")
def _cast(ctx, x):
    dt = proto.TENSOR_DTYPES.get(ctx.attr_i("to"))
    if dt is None:
        raise NotImplementedError(f"Cast to onnx dtype {ctx.attr_i('to')}")
    return x.to(torch_dtype(dt))


@op("CastLike")
def _cast_like(ctx, x, target):
    return x.to(target.dtype)


@op("Identity")
def _identity(ctx, x):
    return x


@op("Dropout")
def _dropout(ctx, x, *rest):
    if len(ctx.node.outputs) > 1:
        return x, torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return x


# ============================================================ reductions


def _dims(x, axes):
    return tuple(range(x.dim())) if axes is None else tuple(a % max(x.dim(), 1) for a in axes)


def _sum(x, axis, keepdims):
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdims) if x.dim() else x


def _prod(x, axis, keepdims):
    out = x
    for d in sorted(_dims(x, axis), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return out


def _amax(x, axis, keepdims):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdims) if x.dim() else x


def _amin(x, axis, keepdims):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdims) if x.dim() else x


def _mean(x, axis, keepdims):
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdims) if x.dim() else x


def _reduce(name: str, fn):
    @op(name, fold_on=(0,))
    def impl(ctx, x, *rest, _fn=fn):
        if ctx.opset >= 18 or (name == "ReduceSum" and ctx.opset >= 13):
            axes_v = ctx.static_input(1) if len(ctx.node.inputs) > 1 else None
            axes = None if axes_v is None else tuple(int(a) for a in np.atleast_1d(axes_v))
        else:
            a = ctx.attr_ints("axes")
            axes = tuple(a) if a is not None else None
        keep = bool(ctx.attr_i("keepdims", 1))
        if (axes is None or axes == ()) and ctx.attr_i("noop_with_empty_axes", 0):
            return x
        if axes == ():
            # an explicitly empty axes tensor (without the noop attr) means
            # reduce over all axes, as an absent input does
            axes = None
        return _fn(x, axes, keep)

    return impl


_reduce("ReduceSum", _sum)
_reduce("ReduceMean", _mean)
_reduce("ReduceMax", _amax)
_reduce("ReduceMin", _amin)
_reduce("ReduceProd", _prod)
_reduce("ReduceL1", lambda x, axis, keepdims: _sum(torch.abs(x), axis, keepdims))
_reduce("ReduceL2", lambda x, axis, keepdims: torch.sqrt(_sum(x * x, axis, keepdims)))
_reduce("ReduceSumSquare", lambda x, axis, keepdims: _sum(x * x, axis, keepdims))
_reduce("ReduceLogSum", lambda x, axis, keepdims: torch.log(_sum(x, axis, keepdims)))
_reduce("ReduceLogSumExp", lambda x, axis, keepdims: torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdims))


def _arg_extreme(ctx, x, fn):
    axis = ctx.attr_i("axis", 0) % x.dim()
    keep = bool(ctx.attr_i("keepdims", 1))
    if ctx.attr_i("select_last_index", 0):
        # ties resolve to the last occurrence: scan the reversed axis
        out = x.shape[axis] - 1 - fn(torch.flip(x, (axis,)), dim=axis)
    else:
        out = fn(x, dim=axis)
    out = out.to(torch.int64)
    return out.unsqueeze(axis) if keep else out


@op("ArgMax")
def _argmax(ctx, x):
    return _arg_extreme(ctx, x, torch.argmax)


@op("ArgMin")
def _argmin(ctx, x):
    return _arg_extreme(ctx, x, torch.argmin)


@op("CumSum")
def _cumsum(ctx, x, axis):
    ax = int(ctx.static_input(1)) % x.dim()
    y = torch.flip(x, (ax,)) if ctx.attr_i("reverse", 0) else x
    out = torch.cumsum(y, dim=ax)
    if ctx.attr_i("exclusive", 0):
        out = torch.roll(out, 1, ax)
        out.narrow(ax, 0, 1).zero_()
    if ctx.attr_i("reverse", 0):
        out = torch.flip(out, (ax,))
    return out


# ============================================================ shape / data


def _shape_of(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


@op("Shape")
def _shape(ctx, x):
    shape = np.asarray(_shape_of(x), np.int64)
    start = ctx.attr_i("start", 0)
    end = ctx.attr_i("end")
    n = len(shape)
    start = max(start + n, 0) if start < 0 else min(start, n)
    if end is None:
        end = n
    end = max(end + n, 0) if end < 0 else min(end, n)
    return shape[start:end]


@op("Size")
def _size(ctx, x):
    return np.asarray(int(np.prod(_shape_of(x), dtype=np.int64)), np.int64)


@op("Constant")
def _constant(ctx):
    for name in ("value", "value_float", "value_int", "value_floats", "value_ints"):
        a = ctx.attrs.get(name)
        if a is None:
            continue
        if name == "value":
            return tensor_to_numpy(a.t, ctx.base_dir)
        if name == "value_float":
            return np.asarray(a.f, np.float32)
        if name == "value_int":
            return np.asarray(a.i, np.int64)
        if name == "value_floats":
            return np.asarray(a.floats, np.float32)
        if name == "value_ints":
            return np.asarray(a.ints, np.int64)
    raise NotImplementedError("Constant: no supported value attribute")


@op("ConstantOfShape")
def _constant_of_shape(ctx, shape):
    dims = tuple(int(d) for d in ctx.static_input(0))
    val = ctx.attr_tensor("value")
    if val is None:
        val = np.zeros((1,), np.float32)
    return np.full(dims, val.reshape(()).item(), val.dtype)


@op("Range")
def _range(ctx, start, limit, delta):
    s, lim, d = ctx.static_input(0), ctx.static_input(1), ctx.static_input(2)
    return np.arange(s.item(), lim.item(), d.item(), dtype=s.dtype)


@op("Reshape", fold_on=(0,))
def _reshape(ctx, x, shape):
    target = [int(d) for d in ctx.static_input(1)]
    if not ctx.attr_i("allowzero", 0):
        target = [x.shape[i] if d == 0 else d for i, d in enumerate(target)]
    return torch.reshape(x, target)


@op("Flatten")
def _flatten(ctx, x):
    axis = ctx.attr_i("axis", 1)
    shape = x.shape
    # a negative axis means axis + rank
    axis = axis + len(shape) if axis < 0 else axis
    a = int(np.prod(shape[:axis], dtype=np.int64))
    b = int(np.prod(shape[axis:], dtype=np.int64))
    return torch.reshape(x, (a, b))


@op("Squeeze", fold_on=(0,))
def _squeeze(ctx, x, *rest):
    if ctx.opset >= 13:
        axes_v = ctx.static_input(1)
        axes = None if axes_v is None else tuple(int(a) for a in np.atleast_1d(axes_v))
    else:
        a = ctx.attr_ints("axes")
        axes = tuple(a) if a is not None else None
    if axes is None:
        return torch.squeeze(x)
    return torch.squeeze(x, tuple(a % x.dim() for a in axes))


@op("Unsqueeze", fold_on=(0,))
def _unsqueeze(ctx, x, *rest):
    if ctx.opset >= 13:
        axes = [int(a) for a in np.atleast_1d(ctx.static_input(1))]
    else:
        axes = ctx.attr_ints("axes")
    out = x
    rank = out.dim() + len(axes)
    for ax in sorted(a % rank for a in axes):
        out = out.unsqueeze(ax)
    return out


@op("Transpose", fold_on=(0,))
def _transpose(ctx, x):
    perm = ctx.attr_ints("perm")
    return x.permute(perm if perm is not None else tuple(reversed(range(x.dim()))))


@op("Concat")
def _concat(ctx, *xs):
    return torch.cat(list(xs), dim=ctx.attr_i("axis"))


@op("Split")
def _split(ctx, x, *rest):
    axis = ctx.attr_i("axis", 0)
    n_out = len(ctx.node.outputs)
    splits = None
    if ctx.opset >= 13 and len(ctx.node.inputs) > 1:
        sv = ctx.static_input(1)
        if sv is not None:
            splits = [int(s) for s in np.atleast_1d(sv)]
    else:
        a = ctx.attr_ints("split")
        splits = list(a) if a is not None else None
    dim = x.shape[axis]
    if splits is None:
        num = ctx.attr_i("num_outputs", n_out)
        chunk = -(-dim // num)
        splits = [chunk] * (num - 1) + [dim - chunk * (num - 1)]
    return tuple(torch.split(x, splits, dim=axis))


def _slice_axis(x, ax, st, en, sp):
    """x[st:en:sp] along `ax` with Python's clamping; a negative step slices
    the flipped axis (torch slicing takes positive steps only)."""
    dim = x.shape[ax]
    start, stop, step = slice(st, en, sp).indices(dim)
    n = len(range(start, stop, step))
    if n == 0:
        return x.narrow(ax, 0, 0)
    if step < 0:
        x, start, step = torch.flip(x, (ax,)), dim - 1 - start, -step
    idx = [slice(None)] * x.dim()
    idx[ax] = slice(start, start + (n - 1) * step + 1, step)
    return x[tuple(idx)]


@op("Slice", fold_on=(0,))
def _slice(ctx, x, *rest):
    if ctx.opset < 10:
        starts = ctx.attr_ints("starts")
        ends = ctx.attr_ints("ends")
        axes = ctx.attr_ints("axes")
        steps = None
    else:
        starts = [int(v) for v in np.atleast_1d(ctx.static_input(1))]
        ends = [int(v) for v in np.atleast_1d(ctx.static_input(2))]
        axes_v = ctx.static_input(3)
        axes = None if axes_v is None else [int(v) for v in np.atleast_1d(axes_v)]
        steps_v = ctx.static_input(4)
        steps = None if steps_v is None else [int(v) for v in np.atleast_1d(steps_v)]
    rank = x.dim()
    if axes is None:
        axes = list(range(len(starts)))
    if steps is None:
        steps = [1] * len(starts)
    out = x
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        out = _slice_axis(out, ax % rank, st, en, sp)
    return out


def _take(x, idx, axis):
    """jnp.take(x, idx, axis) for in-range indices."""
    axis = axis % x.dim()
    out = torch.index_select(x, axis, idx.reshape(-1).to(torch.int64))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))


@op("Gather")
def _gather(ctx, x, indices):
    axis = ctx.attr_i("axis", 0)
    idx = torch.where(indices < 0, indices + x.shape[axis], indices)
    return _take(x, idx, axis)


@op("GatherElements")
def _gather_elements(ctx, x, indices):
    axis = ctx.attr_i("axis", 0)
    idx = torch.where(indices < 0, indices + x.shape[axis], indices)
    return torch.gather(x, axis, idx.to(torch.int64))


@op("ScatterElements")
def _scatter_elements(ctx, x, indices, updates):
    axis = ctx.attr_i("axis", 0)
    reduction = ctx.attr_s("reduction", "none")
    idx = torch.where(indices < 0, indices + x.shape[axis], indices).to(torch.int64)
    if reduction == "add":
        return torch.scatter_add(x, axis, idx, updates)
    if reduction == "none":
        return torch.scatter(x, axis, idx, updates)
    raise NotImplementedError(f"ScatterElements reduction={reduction}")


@op("Expand", fold_on=(0,))
def _expand(ctx, x, shape):
    target = [int(d) for d in ctx.static_input(1)]
    # numpy broadcasting: dims of 1 in the target keep the input's dim
    in_shape = list(x.shape)
    rank = max(len(in_shape), len(target))
    in_shape = [1] * (rank - len(in_shape)) + in_shape
    target = [1] * (rank - len(target)) + target
    final = [max(a, b) for a, b in zip(in_shape, target)]
    return x.reshape(in_shape).expand(final)


@op("Tile", fold_on=(0,))
def _tile(ctx, x, repeats):
    return x.repeat(*[int(r) for r in ctx.static_input(1)])


def _pad_axis(x, ax, lo, hi, mode, cval):
    if lo == 0 and hi == 0:
        return x
    n = x.shape[ax]
    if mode == "constant":
        shape = list(x.shape)
        parts = []
        if lo:
            shape[ax] = lo
            parts.append(torch.full(shape, cval, dtype=x.dtype, device=x.device))
        parts.append(x)
        if hi:
            shape[ax] = hi
            parts.append(torch.full(shape, cval, dtype=x.dtype, device=x.device))
        return torch.cat(parts, dim=ax)
    if mode == "reflect":
        left, right = x.narrow(ax, 1, lo).flip(ax), x.narrow(ax, n - 1 - hi, hi).flip(ax)
    elif mode == "edge":
        left = x.narrow(ax, 0, 1).expand(*x.shape[:ax], lo, *x.shape[ax + 1:])
        right = x.narrow(ax, n - 1, 1).expand(*x.shape[:ax], hi, *x.shape[ax + 1:])
    else:  # wrap
        left, right = x.narrow(ax, n - lo, lo), x.narrow(ax, 0, hi)
    return torch.cat([left, x, right], dim=ax)


@op("Pad", fold_on=(0,))
def _pad(ctx, x, *rest):
    if ctx.opset < 11:
        pads = ctx.attr_ints("pads")
        cval = ctx.attr_f("value", 0.0)
        mode = ctx.attr_s("mode", "constant")
        axes = None
    else:
        pads = [int(p) for p in np.atleast_1d(ctx.static_input(1))]
        cv = ctx.input(2)
        cval = float(ctx.static_input(2).reshape(())) if cv is not None else 0.0
        axes_v = ctx.static_input(3) if len(ctx.node.inputs) > 3 else None
        axes = None if axes_v is None else [int(a) for a in np.atleast_1d(axes_v)]
        mode = ctx.attr_s("mode", "constant")
    if mode not in ("constant", "reflect", "edge", "wrap"):
        raise NotImplementedError(f"Pad mode {mode}")
    rank = x.dim()
    if axes is None:
        axes = list(range(rank))
    axes = [a % rank for a in axes]
    k = len(axes)
    width = [(0, 0)] * rank
    for j, ax in enumerate(axes):
        width[ax] = (pads[j], pads[k + j])
    out = x
    for ax, (lo, hi) in enumerate(width):
        # negative pads crop
        if lo < 0 or hi < 0:
            out = out.narrow(ax, max(0, -lo), out.shape[ax] - max(0, -lo) - max(0, -hi))
        out = _pad_axis(out, ax, max(0, lo), max(0, hi), mode, cval)
    return out


@op("DepthToSpace")
def _depth_to_space(ctx, x):
    b = ctx.attr_i("blocksize")
    n, c, h, w = x.shape
    if ctx.attr_s("mode", "DCR") == "DCR":
        x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    else:
        x = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (b * b), h * b, w * b)


@op("SpaceToDepth")
def _space_to_depth(ctx, x):
    b = ctx.attr_i("blocksize")
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, c * b * b, h // b, w // b)


@op("Trilu")
def _trilu(ctx, x, *rest):
    kv = ctx.static_input(1)
    k = int(kv) if kv is not None else 0
    return torch.triu(x, k) if ctx.attr_i("upper", 1) else torch.tril(x, k)


@op("OneHot")
def _one_hot(ctx, indices, depth, values):
    axis = ctx.attr_i("axis", -1)
    d = int(ctx.static_input(1).reshape(()))
    vals = ctx.static_input(2)
    # indices outside [-d, d-1] give an all-off row (no wrapping)
    valid = (indices >= -d) & (indices < d)
    oh = F.one_hot(torch.where(valid, torch.remainder(indices, d), 0).to(torch.int64), d)
    oh = oh * valid.unsqueeze(-1).to(oh.dtype)
    ax = axis if axis >= 0 else oh.dim() + axis
    oh = torch.movedim(oh, -1, ax)
    # the output takes the values' dtype
    off, on = vals.reshape(-1)[0].item(), vals.reshape(-1)[1].item()
    return (oh * (on - off) + off).to(torch_dtype(vals.dtype))


# ============================================================ linear algebra


@op("MatMul")
def _matmul(ctx, a, b):
    return torch.matmul(a, b)


def _t(x):
    return x.transpose(0, 1) if x.dim() == 2 else x.permute(tuple(reversed(range(x.dim()))))


@op("Gemm")
def _gemm(ctx, a, b, c=None):
    alpha = ctx.attr_f("alpha", 1.0)
    beta = ctx.attr_f("beta", 1.0)
    if ctx.attr_i("transA", 0):
        a = _t(a)
    if ctx.attr_i("transB", 0):
        prod = F.linear(a, b)  # b is (N, K): a @ b.T
    else:
        prod = torch.matmul(a, b)
    out = alpha * prod if alpha != 1.0 else prod
    if c is not None:
        out = out + (beta * c if beta != 1.0 else c)
    return out


@op("Einsum")
def _einsum(ctx, *xs):
    return torch.einsum(ctx.attr_s("equation"), *xs)


# ============================================================ normalization


@op("Softmax")
def _softmax(ctx, x):
    axis = ctx.attr_i("axis", -1 if ctx.opset >= 13 else 1)
    if ctx.opset >= 13:
        return torch.softmax(x, dim=axis)
    # opset < 13: coerce to 2D at `axis`, softmax over the flattened trailing dims
    shape = x.shape
    axis = axis % len(shape)
    flat = x.reshape(int(np.prod(shape[:axis])) if axis else 1, -1)
    return torch.softmax(flat, dim=-1).reshape(shape)


@op("LogSoftmax")
def _log_softmax(ctx, x):
    return torch.log_softmax(x, dim=ctx.attr_i("axis", -1 if ctx.opset >= 13 else 1))


@op("LayerNormalization")
def _layer_norm(ctx, x, scale, bias=None):
    axis = ctx.attr_i("axis", -1)
    eps = ctx.attr_f("epsilon", 1e-5)
    axes = tuple(range(axis % x.dim(), x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=axes, keepdim=True)
    out = (x - mean) / torch.sqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    if len(ctx.node.outputs) > 1:
        return out, mean, 1.0 / torch.sqrt(var + eps)
    return out


def _channel_shape(x):
    return (1, -1) + (1,) * (x.dim() - 2)


@op("InstanceNormalization")
def _instance_norm(ctx, x, scale, bias):
    eps = ctx.attr_f("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=axes, keepdim=True)
    shape = _channel_shape(x)
    return (x - mean) / torch.sqrt(var + eps) * scale.reshape(shape) + bias.reshape(shape)


@op("GroupNormalization")
def _group_norm(ctx, x, scale, bias):
    eps = ctx.attr_f("epsilon", 1e-5)
    g = ctx.attr_i("num_groups")
    n, c = x.shape[:2]
    xg = x.reshape(n, g, c // g, *x.shape[2:])
    axes = tuple(range(2, xg.dim()))
    mean = torch.mean(xg, dim=axes, keepdim=True)
    var = torch.mean((xg - mean) ** 2, dim=axes, keepdim=True)
    out = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = _channel_shape(x)
    if scale.shape[0] == g and g != c:  # opset-18 per-group affine
        scale = torch.repeat_interleave(scale, c // g)
        bias = torch.repeat_interleave(bias, c // g)
    return out * scale.reshape(shape) + bias.reshape(shape)


@op("BatchNormalization")
def _batch_norm(ctx, x, scale, bias, mean, var):
    eps = ctx.attr_f("epsilon", 1e-5)
    shape = _channel_shape(x)
    return (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps) * scale.reshape(shape) \
        + bias.reshape(shape)


@op("LpNormalization")
def _lp_norm(ctx, x):
    axis = ctx.attr_i("axis", -1)
    if ctx.attr_i("p", 2) == 2:
        denom = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        denom = torch.sum(torch.abs(x), dim=axis, keepdim=True)
    return x / denom


# ============================================================ convolution


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _resolve_pads(ctx, x_shape, k_eff, strides, n_spatial):
    auto = ctx.attr_s("auto_pad", "NOTSET")
    if auto in ("NOTSET", ""):
        pads = ctx.attr_ints("pads", [0] * (2 * n_spatial))
        return [(pads[i], pads[n_spatial + i]) for i in range(n_spatial)]
    if auto == "VALID":
        return [(0, 0)] * n_spatial
    out = []
    for i in range(n_spatial):
        in_dim = x_shape[2 + i]
        out_dim = -(-in_dim // strides[i])
        total = max(0, (out_dim - 1) * strides[i] + k_eff[i] - in_dim)
        if auto == "SAME_UPPER":
            out.append((total // 2, total - total // 2))
        else:
            out.append((total - total // 2, total // 2))
    return out


def _pad_spatial(x, pads, value=0.0):
    """F.pad of the spatial dims (lo, hi) each, negative pads cropping."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value) if any(flat) else x


def _bias(out, b, n_spatial):
    return out if b is None else out + b.reshape((1, -1) + (1,) * n_spatial)


@op("Conv")
def _conv(ctx, x, w, b=None):
    n_spatial = x.dim() - 2
    strides = ctx.attr_ints("strides", [1] * n_spatial)
    dilations = ctx.attr_ints("dilations", [1] * n_spatial)
    group = ctx.attr_i("group", 1)
    k_eff = [(w.shape[2 + i] - 1) * dilations[i] + 1 for i in range(n_spatial)]
    pads = _resolve_pads(ctx, x.shape, k_eff, strides, n_spatial)
    if all(lo == hi for lo, hi in pads):
        return _CONV[n_spatial](x, w, b, stride=strides, padding=[lo for lo, _ in pads], dilation=dilations,
                                groups=group)
    return _CONV[n_spatial](_pad_spatial(x, pads), w, b, stride=strides, dilation=dilations, groups=group)


@op("ConvTranspose")
def _conv_transpose(ctx, x, w, b=None):
    n_spatial = x.dim() - 2
    strides = ctx.attr_ints("strides", [1] * n_spatial)
    dilations = ctx.attr_ints("dilations", [1] * n_spatial)
    group = ctx.attr_i("group", 1)
    output_padding = ctx.attr_ints("output_padding", [0] * n_spatial)
    k_eff = [(w.shape[2 + i] - 1) * dilations[i] + 1 for i in range(n_spatial)]
    auto = ctx.attr_s("auto_pad", "NOTSET")
    output_shape = ctx.attr_ints("output_shape")
    if output_shape is not None or auto not in ("NOTSET", ""):
        # pads from the requested output size (SAME_* => out = in * stride)
        pads = []
        for i in range(n_spatial):
            in_dim = x.shape[2 + i]
            want = output_shape[i] if output_shape is not None else in_dim * strides[i]
            total = max(strides[i] * (in_dim - 1) + output_padding[i] + k_eff[i] - want, 0)
            # only SAME_UPPER puts the extra odd pad at the end; SAME_LOWER
            # and NOTSET with output_shape put it at the start
            if auto == "SAME_UPPER":
                pads.append((total // 2, total - total // 2))
            else:
                pads.append((total - total // 2, total // 2))
    else:
        p = ctx.attr_ints("pads", [0] * (2 * n_spatial))
        pads = [(p[i], p[n_spatial + i]) for i in range(n_spatial)]
    # ONNX's ConvTranspose weight (C_in, C_out/group, *k) is torch's layout
    fn = _CONV_T[n_spatial]
    if all(lo == hi for lo, hi in pads) and all(op_ < max(s, d) for op_, s, d in
                                                 zip(output_padding, strides, dilations)):
        return fn(x, w, b, stride=strides, padding=[lo for lo, _ in pads], output_padding=output_padding,
                  groups=group, dilation=dilations)
    # the full output, output_padding zeros at the end, then the pads cropped
    out = fn(x, w, None, stride=strides, groups=group, dilation=dilations)
    out = _pad_spatial(out, [(-lo, hi_op - hi) for (lo, hi), hi_op in zip(pads, output_padding)])
    return _bias(out, b, n_spatial)


# ============================================================ pooling


@op("GlobalAveragePool")
def _global_avg_pool(ctx, x):
    return torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)


@op("GlobalMaxPool")
def _global_max_pool(ctx, x):
    return torch.amax(x, dim=tuple(range(2, x.dim())), keepdim=True)


def _pool_out_shape(in_dim, k_eff, stride, lo, hi, ceil_mode):
    num = in_dim + lo + hi - k_eff
    if ceil_mode:
        return -(-num // stride) + 1
    return num // stride + 1


def _pool_pads(ctx, x, kernel, strides, dilations):
    """(pads with the ceil-mode extension at the end, explicit pads)."""
    n_spatial = x.dim() - 2
    k_eff = [(kernel[i] - 1) * dilations[i] + 1 for i in range(n_spatial)]
    pads = _resolve_pads(ctx, x.shape, k_eff, strides, n_spatial)
    explicit = pads
    if ctx.attr_i("ceil_mode", 0):  # extend the end pad so the last partial window emits
        pads = [(lo, hi + (_pool_out_shape(x.shape[2 + i], k_eff[i], strides[i], lo, hi, 1) - 1) * strides[i]
                 + k_eff[i] - (x.shape[2 + i] + lo + hi)) for i, (lo, hi) in enumerate(pads)]
    return pads, explicit


_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@op("MaxPool")
def _max_pool(ctx, x):
    n_spatial = x.dim() - 2
    kernel = ctx.attr_ints("kernel_shape")
    strides = ctx.attr_ints("strides", [1] * n_spatial)
    dilations = ctx.attr_ints("dilations", [1] * n_spatial)
    pads, _ = _pool_pads(ctx, x, kernel, strides, dilations)
    neg = torch.finfo(x.dtype).min if x.is_floating_point() else torch.iinfo(x.dtype).min
    return _MAXPOOL[n_spatial](_pad_spatial(x, pads, neg), kernel, strides, 0, dilations)


def _window_sum(x, kernel, strides, dilations):
    """Sum over each pooling window (stride, dilation) of an already padded
    x: a depthwise convolution with a kernel of ones."""
    n, c = x.shape[:2]
    n_spatial = x.dim() - 2
    ones = torch.ones((1, 1, *kernel), dtype=x.dtype, device=x.device)
    out = _CONV[n_spatial](x.reshape(n * c, 1, *x.shape[2:]), ones, stride=strides, dilation=dilations)
    return out.reshape(n, c, *out.shape[2:])


@op("AveragePool")
def _avg_pool(ctx, x):
    n_spatial = x.dim() - 2
    kernel = ctx.attr_ints("kernel_shape")
    strides = ctx.attr_ints("strides", [1] * n_spatial)
    dilations = ctx.attr_ints("dilations", [1] * n_spatial)
    include_pad = ctx.attr_i("count_include_pad", 0)
    pads, explicit = _pool_pads(ctx, x, kernel, strides, dilations)
    summed = _window_sum(_pad_spatial(x, pads), kernel, strides, dilations)
    if include_pad and not ctx.attr_i("ceil_mode", 0):
        return summed / float(np.prod(kernel))
    # count_include_pad counts the explicit padding but never the ceil-mode
    # extension; the count window runs over ones padded accordingly
    if include_pad:
        shape = list(x.shape)
        for i in range(n_spatial):
            shape[2 + i] += explicit[i][0] + explicit[i][1]
        ones = torch.ones(shape, dtype=x.dtype, device=x.device)
        count_pads = [(0, pads[i][1] - explicit[i][1]) for i in range(n_spatial)]
    else:
        ones = torch.ones(x.shape, dtype=x.dtype, device=x.device)
        count_pads = pads
    return summed / _window_sum(_pad_spatial(ones, count_pads), kernel, strides, dilations)


# ============================================================ resize


@op("Resize")
def _resize(ctx, x, *rest):
    mode = ctx.attr_s("mode", "nearest")
    coord = ctx.attr_s("coordinate_transformation_mode", "half_pixel")
    nearest_mode = ctx.attr_s("nearest_mode", "round_prefer_floor")
    # unsupported variants raise like every other op's
    if nearest_mode not in ("round_prefer_floor", "round_prefer_ceil", "floor", "ceil"):
        raise NotImplementedError(f"Resize nearest_mode {nearest_mode!r}")
    if ctx.attr_i("antialias", 0):
        raise NotImplementedError("Resize antialias")
    if ctx.attr_i("exclude_outside", 0):
        raise NotImplementedError("Resize exclude_outside")
    if ctx.attr_ints("axes") is not None:
        raise NotImplementedError("Resize axes (per-rank scales/sizes assumed)")
    # inputs: X, roi?, scales?, sizes?
    scales_v = ctx.static_input(2) if len(ctx.node.inputs) > 2 else None
    sizes_v = ctx.static_input(3) if len(ctx.node.inputs) > 3 else None
    in_shape = tuple(x.shape)
    if sizes_v is not None and np.size(sizes_v):
        out_shape = [int(s) for s in sizes_v]
        scales = [out_shape[i] / in_shape[i] for i in range(x.dim())]
    elif scales_v is not None and np.size(scales_v):
        scales = [float(s) for s in scales_v]
        out_shape = [int(math.floor(in_shape[i] * scales[i])) for i in range(x.dim())]
    else:
        raise NotImplementedError("Resize: neither scales nor sizes given")
    out = x
    for axis in range(x.dim()):
        if out_shape[axis] == in_shape[axis]:
            continue
        out = _resize_axis(ctx, out, axis, in_shape[axis], out_shape[axis], scales[axis], mode, coord,
                           nearest_mode)
    return out


def _src_coords(out_dim, in_dim, scale, coord):
    i = np.arange(out_dim, dtype=np.float64)
    if coord == "half_pixel":
        return (i + 0.5) / scale - 0.5
    if coord == "pytorch_half_pixel":
        return (i + 0.5) / scale - 0.5 if out_dim > 1 else np.zeros_like(i)
    if coord == "asymmetric":
        return i / scale
    if coord == "align_corners":
        return i * (in_dim - 1) / max(out_dim - 1, 1)
    raise NotImplementedError(f"Resize coordinate mode {coord}")


def _resize_axis(ctx, x, axis, in_dim, out_dim, scale, mode, coord, nearest_mode):
    """The source indices and weights are host constants, copied to the
    device once per call signature (Ctx.const)."""
    src = _src_coords(out_dim, in_dim, scale, coord)
    if mode == "nearest":
        if nearest_mode == "floor":
            idx = np.floor(src)
        elif nearest_mode == "ceil":
            idx = np.ceil(src)
        elif nearest_mode == "round_prefer_ceil":
            idx = np.floor(src + 0.5)
        else:  # round_prefer_floor
            idx = np.ceil(src - 0.5)
        idx = np.clip(idx, 0, in_dim - 1).astype(np.int64)
        return _take(x, ctx.const(idx, x.device, f"idx{axis}"), axis)
    if mode == "linear":
        lo = np.clip(np.floor(src), 0, in_dim - 1).astype(np.int64)
        hi = np.clip(lo + 1, 0, in_dim - 1)
        w = np.clip(src - lo, 0.0, 1.0).astype(np.float32)
        shape = [1] * x.dim()
        shape[axis] = out_dim
        wj = ctx.const(w.reshape(shape), x.device, f"w{axis}")
        a = _take(x, ctx.const(lo, x.device, f"lo{axis}"), axis)
        b = _take(x, ctx.const(hi, x.device, f"hi{axis}"), axis)
        return a * (1 - wj) + b * wj
    raise NotImplementedError(f"Resize mode {mode}")


@op("Upsample")  # deprecated alias of Resize (opset 9)
def _upsample(ctx, x, scales=None):
    mode = ctx.attr_s("mode", "nearest")
    sc = ctx.attr_floats("scales") if scales is None else [float(s) for s in ctx.static_input(1)]
    out = x
    for axis in range(x.dim()):
        out_dim = int(math.floor(x.shape[axis] * sc[axis]))
        if out_dim == x.shape[axis]:
            continue
        out = _resize_axis(ctx, out, axis, x.shape[axis], out_dim, sc[axis],
                           "nearest" if mode == "nearest" else "linear", "asymmetric", "floor")
    return out


# ============================================================ recurrence
# one host loop over time; each step's input projection is hoisted into one
# product over the whole sequence


def _rnn_common(ctx, kind, n_act, seq_lens):
    if ctx.attrs.get("activations") is not None:
        acts = [s.decode().lower() for s in ctx.attrs["activations"].strings]
        default = ["sigmoid", "tanh", "tanh"] if kind == "LSTM" else ["sigmoid", "tanh"]
        if acts != default * (len(acts) // n_act):
            raise NotImplementedError(f"{kind} non-default activations {acts}")
    if ctx.attr_f("clip") is not None:
        raise NotImplementedError(f"{kind} clip (pre-activation clipping)")
    if seq_lens is not None:
        raise NotImplementedError(
            f"{kind} sequence_lens (per-sequence lengths would be silently ignored; pad and mask outside the graph)")
    if ctx.attr_i("layout", 0):
        raise NotImplementedError(f"{kind} layout=1 (batch-major)")


def _stack_dirs(direction, run_dir):
    if direction == "bidirectional":
        f, b = run_dir(0, False), run_dir(1, True)
        return torch.stack([f[0], b[0]], 1), [torch.stack([a, c], 0) for a, c in zip(f[1:], b[1:])]
    out = run_dir(0, direction == "reverse")
    return out[0][:, None], [s[None] for s in out[1:]]


@op("LSTM")
def _lstm(ctx, x, w, r, b=None, seq_lens=None, init_h=None, init_c=None, p=None):
    """ONNX LSTM, default activations (sigmoid/tanh/tanh), iofc gate order.
    x: (T, B, I); W: (D, 4H, I); R: (D, 4H, H); B: (D, 8H)."""
    _rnn_common(ctx, "LSTM", 3, seq_lens)
    if ctx.attr_i("input_forget", 0):
        raise NotImplementedError("LSTM input_forget coupling")
    if p is not None:
        raise NotImplementedError("LSTM peepholes")
    hidden = ctx.attr_i("hidden_size")
    num_dir, t_len, batch = w.shape[0], x.shape[0], x.shape[1]
    if b is None:
        b = torch.zeros((num_dir, 8 * hidden), dtype=w.dtype, device=w.device)
    wb, rb = b[:, :4 * hidden], b[:, 4 * hidden:]
    zeros = torch.zeros((num_dir, batch, hidden), dtype=x.dtype, device=x.device)
    h0 = zeros if init_h is None else init_h
    c0 = zeros if init_c is None else init_c

    def run_dir(d, reverse):
        xs = torch.flip(x, (0,)) if reverse else x
        gates_x = xs @ w[d].T + wb[d]
        h, c, hs = h0[d], c0[d], []
        for i in range(t_len):
            g = gates_x[i] + h @ r[d].T + rb[d]
            gi, go, gf, cand = torch.chunk(g, 4, dim=-1)  # ONNX iofc order
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(cand)
            h = torch.sigmoid(go) * torch.tanh(c)
            hs.append(h)
        hs = torch.stack(hs, 0)
        return (torch.flip(hs, (0,)) if reverse else hs), h, c

    y, (y_h, y_c) = _stack_dirs(ctx.attr_s("direction", "forward"), run_dir)
    return y, y_h, y_c


@op("GRU")
def _gru(ctx, x, w, r, b=None, seq_lens=None, init_h=None):
    """ONNX GRU, zrh gate order, default activations; x (T, B, I)."""
    _rnn_common(ctx, "GRU", 2, seq_lens)
    hidden = ctx.attr_i("hidden_size")
    lbr = ctx.attr_i("linear_before_reset", 0)
    num_dir, t_len, batch = w.shape[0], x.shape[0], x.shape[1]
    if b is None:
        b = torch.zeros((num_dir, 6 * hidden), dtype=w.dtype, device=w.device)
    wb, rb = b[:, :3 * hidden], b[:, 3 * hidden:]
    h0 = torch.zeros((num_dir, batch, hidden), dtype=x.dtype, device=x.device) if init_h is None else init_h

    def run_dir(d, reverse):
        xs = torch.flip(x, (0,)) if reverse else x
        gates_x = xs @ w[d].T + wb[d]
        rz_r, rh_r = r[d][:2 * hidden], r[d][2 * hidden:]
        rbz, rbh = rb[d][:2 * hidden], rb[d][2 * hidden:]
        h, hs = h0[d], []
        for i in range(t_len):
            zr_x, hx = gates_x[i][..., :2 * hidden], gates_x[i][..., 2 * hidden:]
            zr = torch.sigmoid(zr_x + h @ rz_r.T + rbz)
            z, rgate = zr[..., :hidden], zr[..., hidden:]
            if lbr:
                hh = torch.tanh(hx + rgate * (h @ rh_r.T + rbh))
            else:
                hh = torch.tanh(hx + (rgate * h) @ rh_r.T + rbh)
            h = (1 - z) * hh + z * h
            hs.append(h)
        hs = torch.stack(hs, 0)
        return (torch.flip(hs, (0,)) if reverse else hs), h

    y, (y_h,) = _stack_dirs(ctx.attr_s("direction", "forward"), run_dir)
    return y, y_h

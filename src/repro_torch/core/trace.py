"""Execution-trace extraction: a torch run -> OpGraph (paper Sec V-B, Listing 1).

The torch twin of ``repro.core.trace``, which walks a jaxpr.  Here the
pipeline runs once on ``meta`` tensors (shapes only, no device work) under
a ``TorchDispatchMode``, which sees every aten op below autograd in
execution order.  Each op is classified into the paper's kernel taxonomy
(nn / vsa / simd / mem) and recorded with its dims, bytes and FLOPs, so
the analytical models (Sec V-C) can attach runtime functions to each node.

The correspondences with the jaxpr walk:

- **nn**: ``aten.mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` / ``mv`` /
  ``dot`` are ``dot_general`` (``m`` is batch × lhs rows, ``flops =
  2·b·m·n·k``, ``param_bytes`` the right operand's); ``aten.convolution``
  is ``conv_general_dilated`` with ``k = cin·kh·kw`` read from the OIHW
  weight and ``m = out_elems / cout``.  The port's convolution and max
  pooling take NCHW behind a permute from NHWC and XLA's ``"SAME"`` pad
  (``F.pad``); XLA's take NHWC and pad inside.  Those layout ops fold into
  the convolution or pooling node, whose ``in_bytes`` then counts the
  input as the reference's operand is.
- **vsa**: ``aten._fft_r2c`` / ``_fft_c2r`` / ``_fft_c2c`` are ``fft``,
  with ``nvec`` and ``d`` from the output shape (``d/2+1`` for an rfft).
- **kernel calls** are one node each, as a ``pallas_call`` is.  A kernel
  wrapper (``registry.kernel_call``) announces its call through
  ``registry.note_call`` (the trace is one of its recorders) and reports
  its result and arguments to ``registry.TRACE`` when it returns; the aten
  ops of the plain version in between collapse into that one node.  The node takes the kind, label and dims of the
  reference's Pallas call (``_classify_pallas``), including its quirks:
  the operands are padded to the reference kernel's tile as its wrapper
  pads them, and a non-vsa kernel node carries only ``out_shape`` and
  ``flops = 2·|out|``.  Calls below a kernel's floor take the exact gather
  route and stay the plain ops the reference's ``xla`` lowering shows.
- **bytes** count each element at the width jax gives its type: the
  reference runs without x64, so torch's int64 indices count 4 bytes.
- **simd** and **mem**: elementwise and reduction ops, and data movement,
  as ``_ELEMWISE`` / ``_REDUCE`` / ``_MEM`` of the reference.  A fused
  aten op that jax lowers as several primitives counts the elements of
  that decomposition (``_DECOMPOSED``), and an integer-array ``index``
  adds the ``lt`` / ``add`` / ``select_n`` jnp wraps negative indices
  with.  aten still decomposes some ops differently from XLA (eval-mode
  batchnorm, views, dtype casts), so simd and mem node counts differ from
  the reference's; what the DSE reads (the nn and vsa nodes, the per-node
  bytes of ``memory_plan`` and the SIMD sizing) agrees
  (``tests/test_torch_trace.py`` states the tolerances).

No NSAI pipeline of the port loops inside a stage, so there is no
``scan`` handling (the LM substrate will need it).
"""

from __future__ import annotations

import collections
import math
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.backend import registry
from repro_torch.core.opgraph import OpGraph, OpNode

_NN = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot", "convolution"}
_FFT = {"_fft_r2c", "_fft_c2r", "_fft_c2c"}
_MEM = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
    "transpose", "t", "expand", "slice", "select", "squeeze", "unsqueeze",
    "cat", "stack", "constant_pad_nd", "index", "index_select", "gather",
    "scatter", "scatter_add", "clone", "_to_copy", "copy", "copy_", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "arange", "alias", "detach", "split",
    "split_with_sizes", "unbind", "flip", "as_strided", "lift_fresh",
    "lift_fresh_copy", "repeat", "roll", "narrow", "diagonal",
    "view_as_real", "view_as_complex", "unfold", "_local_scalar_dense",
}


# aten ops that jax lowers as several elementwise / reduction primitives:
# the simd elements of that decomposition, from the op's arguments, its
# input and output element counts and the rows it reduces over
_DECOMPOSED: dict[str, Callable[[tuple, dict, int, int, int], int]] = {
    # mul (x*x), reduce_sum, sqrt
    "linalg_vector_norm": lambda a, kw, n_in, n_out, rows: n_in + 2 * n_out,
    # reduce_sum, div
    "mean": lambda a, kw, n_in, n_out, rows: 2 * n_out,
    # reduce_max, stop_gradient, sub, exp, reduce_sum, div
    "_softmax": lambda a, kw, n_in, n_out, rows: 3 * n_out + 3 * rows,
    # reduce_max, stop_gradient, sub, exp, reduce_sum, log, sub
    "_log_softmax": lambda a, kw, n_in, n_out, rows: 3 * n_out + 4 * rows,
    # clip: one max and / or one min
    "clamp": lambda a, kw, n_in, n_out, rows: n_out * sum(
        b is not None for b in (list(a[1:3]) + [None, None])[:2]),
    # tanh form: integer_pow, tanh, 4 mul, 2 add; erf form: 3 mul, erf, add
    "gelu": lambda a, kw, n_in, n_out, rows: n_out * (
        8 if kw.get("approximate") == "tanh" else 5),
    # floored modulo: rem, 2 ne, 2 lt, and, add, select_n
    "remainder": lambda a, kw, n_in, n_out, rows: 8 * n_out,
}
# the port's convolution and pooling take NCHW behind a permute from the
# reference's NHWC and a "SAME" pad; XLA's take NHWC and pad inside
_NCHW_OPS = {"convolution", "max_pool2d_with_indices"}


# the reference runs jax without x64, where every 64-bit type is 32-bit:
# torch's int64 indices (``arange``, gathers) count at jax's widths
_JAX_WIDTH = {torch.int64: 4, torch.float64: 4, torch.complex128: 8}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * _JAX_WIDTH.get(t.dtype, t.element_size())


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _classify_pallas(kernel: str) -> tuple[str, str]:
    """Kind and label of a kernel call, as the reference classifies its
    Pallas names (``circ_elem_*`` / ``circ_dict_*``, ``qmm_int*``,
    ``fused_match_prob``, ``fused_unbind_classify``,
    ``flash_attention_fwd``) keyed by the port's registry names."""
    return {
        "circ_conv": ("vsa", "circ_conv_kernel"),
        "circ_dict": ("vsa", "circ_conv_kernel"),
        "qmatmul": ("nn", "qmatmul_kernel"),
        "simd_fused": ("simd", "fused_match_prob_kernel"),
        "unbind_classify": ("simd", "pallas:fused_unbind_classify"),
        "flash_attn": ("simd", "pallas:flash_attention_fwd"),
    }[kernel]


def _pad_to(n: int, tile: int) -> int:
    return n + (-n) % tile


def _row_tile(n: int, tile_n: int = 128) -> int:
    """The reference's ``min(tile_n, max(8, n))`` row tile."""
    return min(tile_n, max(8, n))


def _pallas_operands(kernel: str, a: dict
                     ) -> tuple[tuple[int, ...], int, int]:
    """(out_shape, in_bytes, out_bytes) of the reference's ``pallas_call``
    for a wrapper call with these arguments (by the wrapper's parameter
    names): its operands and output as the reference's Pallas wrapper pads
    them to its tiles."""
    if kernel == "circ_conv":                     # circ_elem(x, y)
        x, y = a["x"], a["y"]
        n, b, d = x.shape
        tile = max(1, min(64, (6 * 1024 * 1024) // (2 * d * d * 4)))
        np_ = _pad_to(n, tile)
        io = np_ * b * d * x.element_size()
        return (np_, b, d), io + np_ * b * d * y.element_size(), io
    if kernel == "circ_dict":                     # circ_dict(x, dictionary)
        x, dic = a["x"], a["dictionary"]
        n, b, d = x.shape
        np_ = _pad_to(n, _row_tile(n))
        out = (np_, b, dic.shape[0], d)
        return (out, np_ * b * d * x.element_size() + _nbytes(dic),
                math.prod(out) * x.element_size())
    if kernel == "qmatmul":                       # qmatmul(x_q, w_q, xs, ws)
        x_q, w_q, int4 = a["x_q"], a["w_q"], a["int4"]
        m, k = x_q.shape
        n = w_q.shape[1] * (2 if int4 else 1)
        bm, bk, bn = min(128, m), min(128, k), min(128, n)
        if int4 and bn % 2:
            bn += 1
        mm, nn, kk = _pad_to(m, bm), _pad_to(n, bn), _pad_to(k, bk)
        w_cols = nn // 2 if int4 else nn
        return ((mm, nn), mm * kk + kk * w_cols + 4 * (mm + nn),
                4 * mm * nn)
    if kernel == "simd_fused":                    # fused_match_prob(q, dict)
        q, dic = a["q"], a["dictionary"]
        n, b, d = q.shape
        np_ = _pad_to(n, _row_tile(n))
        m = dic.shape[0]
        return ((np_, m), np_ * b * d * q.element_size() + _nbytes(dic),
                4 * np_ * m)
    if kernel == "unbind_classify":               # (keys, x, w, b)
        keys, x, w, bias = a["keys"], a["x"], a["w"], a["b"]
        n, b, d = x.shape
        np_ = _pad_to(n, _row_tile(n))
        out = (np_, keys.shape[0], w.shape[-1])
        return (out, np_ * b * d * x.element_size() + _nbytes(keys)
                + _nbytes(w) + _nbytes(bias), 4 * math.prod(out))
    if kernel == "flash_attn":                    # (B, S, H, hd) q, k, v
        q, k = a["q"], a["k"]
        b, sq, h, hd = q.shape
        bh, skv = b * h, k.shape[1]
        sqp = _pad_to(sq, min(128, sq))
        skp = _pad_to(skv, min(128, skv))
        el = q.element_size()
        return ((bh, sqp, hd), el * bh * hd * (sqp + 2 * skp),
                el * bh * sqp * hd)
    raise KeyError(f"no reference operand geometry for kernel {kernel!r}")


class _Region:
    """An open kernel call: the deps its plain ops read from outside."""

    __slots__ = ("kernel", "deps")

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.deps: list[str] = []


_INSIDE = "<kernel region>"


class Tracer(TorchDispatchMode):
    """Records every aten op of a run into an :class:`OpGraph`.

    Use through :func:`extract` or ``serve.schedule.meta_run(trace=True)``.
    While a kernel wrapper's call is open (between its
    ``registry.note_call`` and its report to ``registry.TRACE``, both made
    by ``registry.kernel_call``) the ops of its plain version only collect
    deps; the call becomes one node when the wrapper reports."""

    def __init__(self):
        super().__init__()
        self.graph = OpGraph()
        self.counts: dict[str, int] = collections.defaultdict(int)
        self.env: dict[int, str] = {}       # id(tensor) -> producing node
        # id(tensor) -> (node, input tensor) of a permute or constant pad,
        # and ids of NCHW conv / pool outputs: the layout ops around them
        self.layout: dict[int, tuple[str, torch.Tensor]] = {}
        self.nchw_out: set[int] = set()
        self.keep: list[Any] = []           # pin tensors: ids stay unique
        self.regions: list[_Region] = []

    # -- the registry's recorder interface (``registry.note_call``) --------

    def append(self, entry: tuple[str, str]) -> None:
        kernel, route = entry
        if route == "kernel":
            self.regions.append(_Region(kernel))

    def kernel(self, kernel: str, out: torch.Tensor, args: dict) -> None:
        """A wrapper's report of its result and its arguments by name:
        close the open call of ``kernel`` and record it as one node (or
        fold it into an enclosing open call)."""
        region = self.regions.pop()
        if region.kernel != kernel:
            raise RuntimeError(f"kernel call {region.kernel!r} closed as "
                               f"{kernel!r}")
        if self.regions:
            self._add_deps(self.regions[-1].deps, region.deps)
            self._bind([out], _INSIDE)
            return
        kind, label = _classify_pallas(kernel)
        out_shape, in_bytes, out_bytes = _pallas_operands(kernel, args)
        dims: dict = {"out_shape": out_shape, "repeat": 1}
        if kind == "vsa":
            dims["nvec"] = math.prod(out_shape[:-1])
            dims["d"] = out_shape[-1]
            flops = 2 * dims["nvec"] * dims["d"] ** 2
        else:
            flops = 2 * math.prod(out_shape)
        node = OpNode(self._fresh(label), kind, dims, region.deps,
                      out_bytes=out_bytes, in_bytes=in_bytes, flops=flops,
                      label=label)
        self.graph.add(node)
        self._bind([out], node.name)

    # -- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._op(func, args, kwargs, out)
        return out

    def _fresh(self, stem: str) -> str:
        self.counts[stem] += 1
        return f"{stem}_{self.counts[stem]}"

    @staticmethod
    def _add_deps(into: list[str], deps: list[str]) -> None:
        for d in deps:
            if d != _INSIDE and d not in into:
                into.append(d)

    def _deps(self, ins: list[torch.Tensor]) -> list[str]:
        out: list[str] = []
        self._add_deps(out, [self.env[id(t)] for t in ins if id(t) in self.env])
        return out

    def _bind(self, outs: list[torch.Tensor], name: str) -> None:
        for t in outs:
            self.keep.append(t)
            self.env[id(t)] = name

    def _op(self, func, args, kwargs, out) -> None:
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.keep.extend(ins)
        if self.regions:
            self._add_deps(self.regions[-1].deps, self._deps(ins))
            self._bind(outs, _INSIDE)
            return
        prim = func.overloadpacket.__name__
        if prim == "permute" and id(args[0]) in self.nchw_out:
            # NCHW back to NHWC after a convolution or pooling: part of it
            self._bind(outs, self.env[id(args[0])])
            return
        if prim in _NCHW_OPS:
            args = (self._fold_layout(args[0]),) + tuple(args[1:])
            ins = _tensors((args, kwargs))
        deps = self._deps(ins)
        out_bytes = sum(_nbytes(t) for t in outs)
        in_bytes = sum(_nbytes(t) for t in ins)
        out_shape = tuple(outs[0].shape) if outs else ()
        if prim in _NN:
            node = self._nn(prim, args, deps, out_shape, out_bytes)
        elif prim in _FFT:
            n_el = math.prod(out_shape)
            d = out_shape[-1] if out_shape else 1
            node = OpNode(self._fresh("fft"), "vsa",
                          {"nvec": n_el // max(1, d), "d": int(d),
                           "out_shape": out_shape, "repeat": 1},
                          deps, out_bytes=out_bytes, in_bytes=in_bytes,
                          flops=int(5 * n_el * max(1, math.log2(max(2, d)))),
                          label="fft")
        elif prim in _MEM:
            if prim == "index":
                self._index_normalize(args[1], deps)
            node = OpNode(self._fresh(prim), "mem",
                          {"out_shape": out_shape, "repeat": 1}, deps,
                          out_bytes=out_bytes, in_bytes=in_bytes, label=prim)
            if prim in ("permute", "constant_pad_nd"):
                self.layout[id(outs[0])] = (node.name, args[0])
        else:
            elems = math.prod(out_shape)
            if prim in _DECOMPOSED:
                dim = args[1] if prim in ("_softmax", "_log_softmax") else -1
                rows = elems // max(1, out_shape[dim]) if out_shape else 1
                elems = _DECOMPOSED[prim](args, kwargs, ins[0].numel(),
                                          elems, rows)
            node = OpNode(self._fresh(prim), "simd",
                          {"elems": elems, "out_shape": out_shape,
                           "repeat": 1}, deps, out_bytes=out_bytes,
                          in_bytes=in_bytes, flops=elems, label=prim)
        self.graph.add(node)
        self._bind(outs, node.name)
        if prim in _NCHW_OPS:
            self.nchw_out.add(id(outs[0]))

    def _index_normalize(self, indices, deps: list[str]) -> None:
        """jnp's integer-array indexing wraps negative indices with ``lt``,
        ``add`` and ``select_n`` over the index array before its gather,
        where aten's ``index`` does it inside: one simd node of those
        three elementwise ops."""
        elems = 3 * sum(t.numel() for t in _tensors(indices)
                        if not t.dtype.is_floating_point
                        and t.dtype != torch.bool)
        if elems:
            self.graph.add(OpNode(
                self._fresh("index_normalize"), "simd",
                {"elems": elems, "out_shape": (elems // 3,), "repeat": 1},
                list(deps), flops=elems, label="index_normalize"))

    def _fold_layout(self, x: torch.Tensor) -> torch.Tensor:
        """The NHWC tensor a convolution or pooling input was laid out
        from: the ``"SAME"`` pad and the NHWC -> NCHW permute in front of it
        fold into the op, as XLA pads inside ``conv_general_dilated`` /
        ``reduce_window`` and takes NHWC.  Only a layout node just added
        (the last in the graph, so nothing else read it) is folded."""
        while id(x) in self.layout:
            name, src = self.layout[id(x)]
            if not self.graph.order or self.graph.order[-1] != name:
                break
            self.graph.order.pop()
            del self.graph.nodes[name]
            x = src
        return x

    def _nn(self, prim: str, args, deps, out_shape, out_bytes) -> OpNode:
        if prim == "convolution":
            x, w = args[0], args[1]
            out_elems = math.prod(out_shape)
            cout = w.shape[0]
            k = math.prod(w.shape[1:])          # OIHW: cin*kh*kw
            return OpNode(self._fresh("conv"), "nn",
                          {"m": out_elems // max(1, cout), "n": cout, "k": k,
                           "out_shape": out_shape, "repeat": 1},
                          deps, out_bytes=out_bytes,
                          in_bytes=_nbytes(x) + _nbytes(w),
                          param_bytes=_nbytes(w),
                          flops=2 * out_elems * k, label="conv2d")
        lhs, rhs = (args[1], args[2]) if prim in ("addmm", "baddbmm") \
            else (args[0], args[1])
        if prim in ("bmm", "baddbmm"):
            b, m, k = lhs.shape
            n = rhs.shape[-1]
        elif prim == "mm" or prim == "addmm":
            b, (m, k), n = 1, lhs.shape, rhs.shape[-1]
        elif prim == "mv":
            b, (m, k), n = 1, lhs.shape, 1
        else:                                    # dot
            b, m, k, n = 1, 1, lhs.shape[0], 1
        return OpNode(self._fresh("dot_general"), "nn",
                      {"m": m * b, "n": n, "k": k, "out_shape": out_shape,
                       "repeat": 1},
                      deps, out_bytes=out_bytes,
                      in_bytes=_nbytes(lhs) + _nbytes(rhs),
                      param_bytes=_nbytes(rhs), flops=2 * b * m * n * k,
                      label="matmul")

    # -- lifetime ------------------------------------------------------------

    def __enter__(self):
        if registry.TRACE is not None:
            raise RuntimeError("a trace is already open")
        registry.TRACE = self
        registry._RECORDERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            registry._RECORDERS.remove(self)
            registry.TRACE = None
            if self.regions and exc[0] is None:
                raise RuntimeError(
                    f"kernel calls never reported to the trace: "
                    f"{[r.kernel for r in self.regions]}")


def extract(fn: Callable, *args, **kwargs) -> OpGraph:
    """Run ``fn`` on ``args`` (``meta`` tensors: no device work) under a
    :class:`Tracer` and return its OpGraph."""
    with Tracer() as tracer, torch.no_grad():
        fn(*args, **kwargs)
    return tracer.graph

"""XLA-CPU's float32 orders, spelled out in PyTorch.

The JAX package's results on the CPU are XLA's: its LLVM code contracts a
product and the sum it feeds into one fused multiply-add, sums a short
axis in a fixed order, and turns some reductions into 8-lane vector loops.
Where the port must give the reference's bits (a rounding that decides a
code, an argmin over ties) it computes with these helpers instead of a
library reduction, whose order differs between the CPU and the card.

`_fma` and the ordered sums (`_sum`, `_dot`, `_dot_mm`, `_dot_vec16`) are
wrappers of the kernels of `csrc/xla_order_kernels.cu` (`xla_fma`,
`xla_reduce`): a float32 CUDA tensor launches the kernel, which spells
each rounding out (`__fmaf_rn`, `__fadd_rn`), and counts the launch in
`cuda_etc1s.LAUNCHES`; a CPU tensor runs the plain version beside it
(`fma_reference`, `reduce_reference`), a chain of elementwise float32
operators with each fused multiply-add emulated through float64 and
rounded once, as the kernels' `__fmaf_rn` and XLA-CPU's `vfmadd` round:
the product of two float32 is exact in float64, the sum is rounded there
to odd, and that rounds correctly to float32. Integer sums are exact in
any order and stay a library sum.

The same library holds four kernels of whole compositions of these
helpers, the UASTC search's masked line fit and its mode trials
(`uastc_line_fit`; `uastc_mode_trial`, single-subset; `uastc_subset_trial`,
2 and 3 subsets; `uastc_dualplane_trial`), whose wrappers live with the
search in `codecs/uastc/encode.py` and launch through `launch()`.
"""

import array

import numpy as np
import torch

from .cuda_etc1s import _launched, _raise_on

_MAX_DIMS = 8
_ORDERS = {"sum": 0, "dot": 1, "dot_mm": 2, "dot_vec16": 3}


def _on_card(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in xs)


def _card_operand(x, dev):
    """A float32 tensor on `dev`, or a Python float that float32 holds
    exactly (the kernels take their scalars as float32)."""
    if not isinstance(x, torch.Tensor):
        if float(np.float32(x)) != float(x):
            raise ValueError(f"scalar {x!r} is not a float32 value")
        return float(x)
    if x.device != dev:
        raise ValueError(f"tensors on different devices: {dev} vs {x.device}")
    if x.dtype == torch.float32:
        return x
    if x.is_floating_point() or x.is_complex():
        raise TypeError(f"expected float32, got {x.dtype}")
    return x.float()                       # integers: exact below 2**24


def _broadcast(ops):
    """The broadcast shape of the tensor operands, and each operand's
    strides over it (0 along broadcast dims; None for a scalar)."""
    tensors = [x for x in ops if isinstance(x, torch.Tensor)]
    nd = max(x.dim() for x in tensors)
    shape = [1] * nd
    for x in tensors:
        for d, n in enumerate(x.shape, nd - x.dim()):
            if n != 1:
                if shape[d] not in (1, n):
                    raise ValueError(f"shapes {[tuple(t.shape) for t in tensors]}"
                                     " do not broadcast")
                shape[d] = n
    strides = []
    for x in ops:
        if not isinstance(x, torch.Tensor):
            strides.append(None)
            continue
        lead = nd - x.dim()
        st = x.stride()
        strides.append([0] * lead + [st[d] if n != 1 else 0
                                     for d, n in enumerate(x.shape)])
    return shape, strides


def _layout(shape, strides):
    """(nd, meta) of an output `shape` read at each operand's `strides`
    (None: a scalar), size-1 dims dropped and dims that every operand steps
    through contiguously merged: meta is an int64 array of the _MAX_DIMS
    sizes, then three operands' _MAX_DIMS strides (the kernels' layout; 0
    past the operands given)."""
    sizes, merged = [], [[] for _ in strides]
    cols = [st if st is not None else [0] * len(shape) for st in strides]
    for d, n in enumerate(shape):
        if n == 1:
            continue
        if sizes and all(m[-1] == c[d] * n for m, c in zip(merged, cols)):
            sizes[-1] *= n
            for m, c in zip(merged, cols):
                m[-1] = c[d]
        else:
            sizes.append(n)
            for m, c in zip(merged, cols):
                m.append(c[d])
    if not sizes:
        sizes = [1]
        merged = [[0] for _ in strides]
    nd = len(sizes)
    if nd > _MAX_DIMS:
        raise ValueError(f"{nd} dimensions, at most {_MAX_DIMS}")
    pad = [0] * (_MAX_DIMS - nd)
    flat = array.array("q", sizes + pad)
    for m in merged:
        flat += array.array("q", m + pad)
    # the kernels read three operands' strides: zeros for those not given
    flat += array.array("q", [0] * (_MAX_DIMS * (3 - len(merged))))
    return nd, flat


# The launch path of every call on the card: the kernel library's functions
# (argument types declared once, in `_build`), the current stream by its
# raw handle, and a plan per (operand shapes, strides, dtypes, devices;
# scalar values) that holds the output shape and the kernels' layout
# buffer, built once by `_broadcast` / `_layout` after the operands are
# checked (`_float32_ops`), and reused after.
_card = None
_PLANS = {}
_MAX_PLANS = 4096


class _Card:
    def __init__(self):
        from ._build import get_lib

        lib = get_lib("xla_order_kernels")
        self.fma, self.reduce = lib.xla_fma, lib.xla_reduce
        self.line_fit = lib.uastc_line_fit
        self.mode_trial = lib.uastc_mode_trial
        self.subset_trial = lib.uastc_subset_trial
        self.dualplane_trial = lib.uastc_dualplane_trial
        self.stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda idx: torch.cuda.current_stream(idx).cuda_stream)
        self.current = getattr(torch._C, "_cuda_getDevice", None) \
            or torch.cuda.current_device


def _lib() -> _Card:
    global _card
    if _card is None:
        _card = _Card()
    return _card


def launch(kernel: str, idx, *args):
    """The library's function `kernel` on device idx with *args and the
    current stream of that device; returns its status."""
    card = _card or _lib()
    fn = getattr(card, kernel)
    if idx == card.current():
        return fn(*args, card.stream(idx))
    with torch.cuda.device(idx):
        return fn(*args, card.stream(idx))


def _key(x):
    if isinstance(x, torch.Tensor):
        return x.shape, x.stride(), x.dtype, x.device
    return x


def _float32_ops(ops):
    """The operands as the kernels take them: float32 tensors on one card
    (integer tensors converted), Python floats that float32 holds exactly;
    and their device."""
    dev = next(x.device for x in ops
               if isinstance(x, torch.Tensor) and x.is_cuda)
    return tuple(_card_operand(x, dev) for x in ops), dev


def _store(key, plan):
    if len(_PLANS) >= _MAX_PLANS:
        _PLANS.clear()
    _PLANS[key] = plan
    return plan


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def _fma_card(a, b, c):
    key = ("fma", _key(a), _key(b), _key(c))
    plan = _PLANS.get(key)
    if plan is None:
        ops, dev = _float32_ops((a, b, c))
        if any(x is not y for x, y in zip(ops, (a, b, c))
               if isinstance(y, torch.Tensor)):
            return _fma_card(*ops)               # integer tensors converted
        shape, strides = _broadcast(ops)
        nd, meta = _layout(shape, strides)
        plan = _store(key, (tuple(shape), _numel(shape), nd,
                            meta.buffer_info()[0], dev, dev.index,
                            isinstance(a, torch.Tensor),
                            isinstance(b, torch.Tensor),
                            isinstance(c, torch.Tensor), meta))
    shape, n, nd, meta_ptr, dev, idx, ta, tb, tc, _ = plan
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    status = launch("fma", idx, a.data_ptr() if ta else None,
                    b.data_ptr() if tb else None,
                    c.data_ptr() if tc else None, 0.0 if ta else a,
                    0.0 if tb else b, 0.0 if tc else c, out.data_ptr(), n,
                    nd, meta_ptr)
    _launched("xla_fma")
    if status:
        _raise_on(status, "xla_fma")
    return out


def _reduce_card(a, b, dim: int, order: str):
    key = ("reduce", dim, _key(a), _key(b))
    plan = _PLANS.get(key)
    if plan is None:
        ops, dev = _float32_ops((a,) if b is None else (a, b))
        if not all(isinstance(x, torch.Tensor) for x in ops):
            raise TypeError("the ordered sums take tensors")
        if ops[0] is not a or (b is not None and ops[1] is not b):
            return _reduce_card(*ops, dim, order) if b is not None \
                else _reduce_card(ops[0], None, dim, order)
        shape, strides = _broadcast(ops)
        d = dim % len(shape)
        k_len = shape.pop(d)
        k_st = [st.pop(d) for st in strides] + [0]
        nd, meta = _layout(shape, strides)
        plan = _store(key, (tuple(shape), _numel(shape), k_len, k_st[0],
                            k_st[1], nd, meta.buffer_info()[0], dev,
                            dev.index, meta))
    shape, n, k_len, ka, kb, nd, meta_ptr, dev, idx, _ = plan
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if n == 0 or k_len == 0:
        return out.zero_() if k_len == 0 else out
    status = launch("reduce", idx, a.data_ptr(),
                    None if b is None else b.data_ptr(), out.data_ptr(), n,
                    k_len, ka, kb, _ORDERS[order], nd, meta_ptr)
    _launched("xla_reduce")
    if status:
        _raise_on(status, "xla_reduce")
    return out


def fma_reference(a, b, c):
    """Plain version of `_fma`, on any device: a * b + c rounded once to
    float32. The product of two float32 values (or of a Python float that
    is a float32 value) is exact in float64. The sum with c is rounded
    there to odd: TwoSum gives the rounded sum s and its exact residual e,
    and where e is not 0 and s's last significand bit is even, s steps one
    ulp toward e. A result rounded to odd at 53 bits rounds to nearest at
    float32's 24 as the exact value would (53 >= 2 * 24 + 2), so the one
    rounding is float32's own."""
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else x
               for x in (a, b, c))          # a Python float is a double
    p = a * b
    s = p + c
    v = s - p
    e = (p - (s - v)) + (c - v)
    odd = (e != 0) & torch.isfinite(e) & ((s.view(torch.int64) & 1) == 0)
    step = torch.nextafter(s, torch.where(e > 0, torch.inf, -torch.inf)
                           .to(torch.float64))
    return torch.where(odd, step, s).float()


def reduce_reference(a, b, dim: int, order: str):
    """Plain version of the ordered sums, on any device: `order` "sum" adds
    the terms of a in index order; "dot", "dot_mm" and "dot_vec16" sum a * b
    as `_dot`, `_dot_mm` and `_dot_vec16` say."""
    if order == "sum":
        parts = a.unbind(dim)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc
    pa, pb = torch.broadcast_tensors(a, b)
    pa, pb = pa.unbind(dim), pb.unbind(dim)
    acc = pa[0] * pb[0]
    if order == "dot_vec16":
        for k in range(1, 8):
            acc = acc + pa[k] * pb[k]
        for k in range(8, 16):
            acc = fma_reference(pa[k], pb[k], acc)
        return acc
    if order == "dot_mm" and len(pa) >= 4:
        accs = [pa[i] * pb[i] for i in range(4)]
        for k in range(4, len(pa)):
            accs[k % 4] = fma_reference(pa[k], pb[k], accs[k % 4])
        return (accs[0] + accs[1]) + (accs[2] + accs[3])
    for x, y in zip(pa[1:], pb[1:]):
        acc = fma_reference(x, y, acc)
    return acc


def _sum(x, dim: int):
    """Sum over a short axis, added in index order."""
    if not x.is_floating_point():
        return x.sum(dim)
    if x.is_cuda:
        return _reduce_card(x, None, dim, "sum")
    return reduce_reference(x, None, dim, "sum")


def _fma(a, b, c):
    """a * b + c rounded once (a fused multiply-add)."""
    if _on_card(a, b, c):
        return _fma_card(a, b, c)
    return fma_reference(a, b, c)


def _sqrt(x):
    """Correctly rounded float32 square root on either device (a CPU
    build's vectorized float32 sqrt is not always the nearest float; CUDA's
    `sqrtf` is, as XLA's is)."""
    if x.is_cuda and x.dtype == torch.float32:
        return torch.sqrt(x)
    return x.double().sqrt().float()


def _dot(a, b, dim: int = -1):
    """Sum over a short axis of a * b as a chain of fused multiply-adds in
    index order."""
    if _on_card(a, b):
        return _reduce_card(a, b, dim, "dot")
    return reduce_reference(a, b, dim, "dot")


def _dot_mm(a, b, dim: int = -1):
    """Sum over a short axis of a * b in the order of a blocked matrix
    product: four accumulators take every fourth term as fused
    multiply-adds and are added pairwise at the end; fewer than four terms
    are one chain."""
    if _on_card(a, b):
        return _reduce_card(a, b, dim, "dot_mm")
    return reduce_reference(a, b, dim, "dot_mm")


def _dot_vec16(a, b, dim: int = -1):
    """Sum over a 16-long axis of a * b in the order of the reference's
    vector-vector product (one channel): the first eight products are
    rounded and added in turn, the last eight are fused multiply-adds."""
    if _on_card(a, b):
        return _reduce_card(a, b, dim, "dot_vec16")
    return reduce_reference(a, b, dim, "dot_vec16")


def _tree8(q):
    """The 8 lanes of a vector loop added pairwise: lane i + lane i+4, then
    i + i+2, then 0 + 1."""
    h = q[..., :4] + q[..., 4:]
    g = h[..., :2] + h[..., 2:]
    return g[..., 0] + g[..., 1]


def _sum_tree16(x):
    """Sum over a last axis of 16 in the order of an 8-lane vector loop:
    the two halves added lane by lane, then the lanes pairwise (4, 2, 1)."""
    return _tree8(x[..., :8] + x[..., 8:])


def _cross6(a, b):
    """(N, C) products of the rows of a (N, 6) and b (C, 6), summed as
    XLA's CPU matrix product sums them. Its order depends on C alone: two
    fused multiply-add chains, over the even and the odd terms, added at the
    end, where C mod 64 is 1..32; one chain in index order (`_dot`) where
    it is 0 or 33..63. Measured against the reference's jitted dot at C
    24..8,192 and N 512..24,576 on an x86-64 Intel Xeon with AVX-512 and
    AMX (XLA's CPU backend tiles its products by the host's vector width,
    so a host with another ISA may sum otherwise:
    `tests/test_torch_etc1s_encode.py` holds this rule against
    `jax.jit(jnp.dot)` on the host that runs it). The plain version of the
    `cross6_*` kernels, which spell the same rule out on the card."""
    lanes = 2 if 1 <= b.shape[0] % 64 <= 32 else 1
    # the fused multiply-adds of `_dot` / `_dot_mm`, each rounded once
    acc = [a[:, None, k] * b[None, :, k] for k in range(lanes)]
    for k in range(lanes, a.shape[1]):
        acc[k % lanes] = fma_reference(a[:, None, k], b[None, :, k],
                                       acc[k % lanes])
    return acc[0] if lanes == 1 else acc[0] + acc[1]


def _sum_sq_tree16(d):
    """Sum over a last axis of 16 of d * d in the order of the same vector
    loop with the second half's squares contracted: lane i is
    fma(d_{i+8}, d_{i+8}, d_i * d_i), then the lanes pairwise (4, 2, 1)."""
    lo, hi = d[..., :8], d[..., 8:]
    return _tree8(_fma(hi, hi, lo * lo))

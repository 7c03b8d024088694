"""K1: the one-layer fused Allegro kernel (counterpart of
``pair_allegro_tpu/ops/pallas_stack.py:_layer1_fwd_kernel`` /
``_layer1_bwd_kernel``, entry ``allegro_layer_fused_t``).

One call computes a whole Allegro layer on the feature-major layout of the
TABLE edge list (E = n_centers * K, each center's K edges contiguous):

  wz  = (Wenv^T x) / sqrt(ns) * u;  env = per-center sum wz (x) Y / sqrt(avg_n)
  T   = channelwise TP of V with env;  V' = per-l3 mix of T;  inv = T[l3=0]
  x'  = (x + MLP([x; inv]) * u) / sqrt(2)

On a CUDA tensor :func:`fused_layer` launches the hand-written Hopper kernel
pair in ``csrc/fused_layer.cu`` (built with ``nvcc`` at first use, bound with
``ctypes``), or at bf16 its bf16 build ``csrc/fused_layer_bf16.cu`` (the
``interior="bf16"`` tier: bf16 activations, f32 sums in registers, one bf16
tensor-core pass per product on the weights :func:`pack_pairs` lays out);
on a CPU tensor it runs :func:`fused_layer_reference`, the plain PyTorch
version of the same function, at the tensors' dtype.  What bounds the
kernel on the card and what its design does about it is written at the top
of the CUDA sources.

The products follow the matmul precision policy (``ops/prec.py``): at f32
the call's :func:`prec.kernel_mode` picks the build, ``tf32x3`` (3xTF32,
``fused_layer.cu``), ``bf16x3`` (``fused_layer_bf16x3.cu``: JAX's HIGH
split on the weights :func:`pack_x3` lays out) or ``bf16`` (one pass,
``fused_layer_onepass.cu``), and the plain version computes the same
mode's products (``prec.kmm``).  The forward fixes the mode its backward
uses.  At bf16 the build and the plain version round the Python-float
constants as JAX's weak typing does (``mlp.weak_scalar``; the card's f32
oracle passes ``scalars=torch.bfloat16``).

Weight cotangents come back NaN-filled, the contract of the TPU kernel
(``pallas_stack.py:1363``): MD forces never need them, and a training-style
use fails loudly instead of silently returning zeros.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from pair_allegro_tpu_torch.ops import prec
from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.mlp import silu_norm_const, weak_scalar
from pair_allegro_tpu_torch.ops.tp import _nonzeros, num_paths_per_l
from pair_allegro_tpu_torch.ops.weight_cache import LAYOUTS

_MAX_ENT, _MAX_D, _MAX_LAT = 512, 16, 8
# the kernels' shared-memory table (struct Meta in csrc/allegro_tiles.cuh)
_META_DTYPE = np.dtype(
    [
        ("n_ent", np.int32),
        ("ent", np.int32, _MAX_ENT),
        ("w", np.float32, _MAX_ENT),
        ("rowstart", np.int32, _MAX_D + 1),
        ("rowP", np.int32, _MAX_D),
        ("rowmix", np.int32, _MAX_D),
        ("rownorm", np.float32, _MAX_D),
        ("latdim", np.int32, _MAX_LAT + 1),
        ("latoff", np.int32, _MAX_LAT),
    ]
)


launches = LaunchCounts("K1.tf32x3")  # the f32 kernel's (3xTF32 products)
launches_bf16 = LaunchCounts("K1.bf16")  # the bf16 build's (bf16 operands)
launches_bf16x3 = LaunchCounts("K1.bf16x3")  # the f32 bf16x3 build's
launches_onepass = LaunchCounts("K1.onepass")  # the f32 one-pass build's

# the launchers' constants (csrc/allegro_tiles.cuh): threads per block, the
# edge tile, the shared memory a block may use, and what it may use where
# two blocks share an H100 SM (233,472 bytes an SM, 1 KB reserved per block)
NT, ET, SMEM_MAX, SHARE2 = 256, 32, 232448, 233472 // 2 - 1024
META_WORDS = _META_DTYPE.itemsize // 4
# the tensor-core kernels' (csrc/allegro_mma.cuh: the layer body, K2, K4):
# the row stride of their product tiles (LDS_WIDE, or LDS_MIN where the
# tiles need it) and of their V tiles, the weight ring's most words forward
# and backward and its least; STACK's slot for its layer's parameters
LDS_WIDE, LDS_MIN, LDV = 40, 32, 32
RING_FWD, RING_BWD, RING_MIN, P_WORDS = 4096, 8192, 2 * 8 * (128 + 8), 128
# words of struct MlpTab: n, maxw, dim[MAX_LAT + 1], off[MAX_LAT],
# scale[MAX_LAT]; K6 and K7 copy two of them into shared memory
MT_WORDS = 2 + (_MAX_LAT + 1) + 2 * _MAX_LAT


def _ceil4(n: int) -> int:
    return -(-n // 4) * 4


def ring_holds(kd: int, m: int, ring: int) -> bool:
    """``ring_holds`` (csrc/allegro_mma.cuh): a product's A (kd, m) stays
    whole in a ring of ``ring`` words (one pass of at most 128 output rows,
    at most two chunks), so the next row of the same l3 skips its staging."""
    if ring <= 0 or m > 128:
        return False
    sa = m if m % 32 == 0 else -(-m // 16) * 16 + 8
    return -(-kd // ((ring // 2 // sa) // 8 * 8)) <= 2


def table_fits(lmax: int, parity: bool) -> bool:
    """Whether the 3j entries of (l_max, parity) fit the Meta table."""
    n_ent = sum(len(e) for e, _ in _row_tables(lmax, parity))
    return (lmax + 1) ** 2 <= _MAX_D and n_ent <= _MAX_ENT


def widths_ok(ns: int, c: int, cout: int, d: int, latd: tuple, lmax: int, parity: bool) -> bool:
    """The refusal conditions of ``layer_launch`` (csrc/allegro_layer.cuh)
    on the layer's widths, every form."""
    nlat, in0 = len(latd) - 1, latd[0]
    hidden = latd[1:-1]
    maxw = max(hidden) if hidden else 4
    if not table_fits(lmax, parity) or d > _MAX_D or not 1 <= nlat <= _MAX_LAT:
        return False
    return not (NT % c or NT // c > ET or ns % 4 or c % 4 or cout % 4 or in0 % 4 or maxw % 4)


def block_layout(ns: int, c: int, cout: int, d: int, latd: tuple, lmax: int, parity: bool,
                 first_v: bool, bwd: bool, form: str = "plain", n_in: int = 0, xmaxw: int = 4,
                 hzrows: int = 0) -> tuple[int, int, int]:
    """(bytes, tile stride, ring words) of the shared memory ``layer_layout``
    (csrc/allegro_layer.cuh) gives one block of the layer in ``form``
    ("plain": K1, "embed": K6, "readout": K7, "stack": K8), a transcription
    of its sum: the tables, the tiles (product tiles at the tile stride, V at
    LDV), the weight ring and a scratch region R as large as the largest
    phase, each region rounded up to 16 bytes.  The stride is LDS_WIDE with
    the ring, else LDS_MIN with the ring, else LDS_MIN without one; where
    none fits, the bytes of the last (above SMEM_MAX).  K6 and K7 pass their
    MLPs' input width (``n_in``), widest hidden layer (``xmaxw``) and
    pre-activation rows (``hzrows``)."""
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    nlat, in0 = len(latd) - 1, latd[0]
    hidden = latd[1:-1]
    maxw = max(hidden) if hidden else 4
    maxpc = max(P) * c
    if bwd:
        rows = max(c, 2 * ns + (nlat - 1) * maxw + 2 * max(in0, maxw), 2 * c + ns)
    else:
        rows = max(c, maxpc, 2 * max(maxw, ns))
    if form == "embed":
        nin = _ceil4(n_in)
        rows = max(rows, nin + 2 * xmaxw)
        if bwd:
            rows = max(rows, 2 * c + 2 * ns + hzrows + nin + 2 * max(xmaxw, ns, nin))
    elif form == "readout":
        rows = max(rows, 2 * ns + (nlat - 1) * maxw + 2 * max(xmaxw, ns) + hzrows + 2 if bwd
                   else 2 * xmaxw + 2)
    for lds in (LDS_WIDE, LDS_MIN):
        regions = (META_WORDS, P_WORDS if form == "stack" else 0, _MAX_ENT if bwd else 0,
                   2 * MT_WORDS if form in ("embed", "readout") else 0, d * c, d * c if bwd else 0,
                   in0 * lds, d * c * LDV, c * lds if first_v else 0, d * lds, lds,
                   lds if bwd else 0)
        r_words = rows * lds
        if bwd:  # the TP / mix backward: dV, dT, dV' (K6: dpT and its share of dx in dT's rows)
            r_words = max(r_words, d * c * LDV
                          + ((max(maxpc, c + ns) if form == "embed" else maxpc) + cout) * lds)
        rest = sum(_ceil4(w) for w in regions) + r_words
        left = (SMEM_MAX // 4 - rest) // 8 * 8
        if left >= RING_MIN:
            ring = min(RING_BWD if bwd else RING_FWD, left)
            return 4 * (rest + ring), lds, ring
    return 4 * rest, LDS_MIN, 0


def block_bytes(*args, **kwargs) -> int:
    """The bytes of ``block_layout`` (same arguments)."""
    return block_layout(*args, **kwargs)[0]


def kernel_takes(ns: int, c: int, cout: int, d: int, latd: tuple, lmax: int, parity: bool,
                 dtype=torch.float32) -> bool:
    """Whether ``k1_launch`` (csrc/fused_layer.cu, or a build of ``dtype``:
    ``build_for``) takes a layer of these widths in every form, forward and
    backward: its refusal conditions and its shared-memory sum, mirrored
    here so that a caller decides before any launch.  Every build keeps its
    tiles f32 in shared memory and its ring as many words (a bf16x3 ring
    too shallow for a 16-row chunk reads its weights without it), so its
    sum is the f32 one and the answer does not depend on the policy."""
    return dtype in (torch.float32, torch.bfloat16) and widths_ok(
        ns, c, cout, d, latd, lmax, parity) and all(
        block_bytes(ns, c, cout, d, latd, lmax, parity, first_v, bwd) <= SMEM_MAX
        for first_v in (False, True) for bwd in (False, True))


@dataclasses.dataclass(frozen=True, eq=False)
class K1Weights:
    """One layer's weights in the kernel's layout, made by
    :func:`prepare_layer` from the JAX-layout layer (``env_weight`` (ns, C),
    ``latent_mlp`` {"w": [(in, out), ...]}, ``mix`` {"l0": (C*P, C), ...}
    with c-major rows).  The mix rows and the inv rows of the first latent
    weight are permuted to p-major (row = p*C + c); the transposes serve the
    backward.  These are detached copies; ``leaves`` are the layer's own
    tensors, which receive the (NaN) weight cotangents."""

    env_w: torch.Tensor  # (ns, C)
    env_wT: torch.Tensor  # (C, ns)
    lat: tuple  # (in, out) per layer, first layer's inv rows p-major
    mix: tuple  # (P*C, Cout) per l3, p-major rows
    lat_flat: torch.Tensor
    latT_flat: torch.Tensor
    mix_flat: torch.Tensor
    mixT_flat: torch.Tensor
    meta: torch.Tensor  # int32 table of struct Meta
    lmax: int
    parity: bool
    leaves: tuple  # env_weight, latent_mlp w..., mix l0..l_max of the tree

    @property
    def dims(self):
        ns, c = self.env_w.shape
        latd = [self.lat[0].shape[0]] + [w.shape[1] for w in self.lat]
        return ns, c, self.mix[0].shape[1], latd

    def tensors(self):
        return self.leaves

    def weights(self) -> tuple:
        """env_w, env_wT, lat, latT, mix and mixT, the launcher's order."""
        return (self.env_w, self.env_wT, self.lat_flat, self.latT_flat, self.mix_flat,
                self.mixT_flat)

    @functools.cached_property
    def packed(self) -> tuple:
        """:meth:`weights` for the bf16 and one-pass builds: each matrix
        :func:`pack_pairs`-ed, the flat buffers in the f32 order (every
        offset halves)."""
        return self._packs(pack_pairs)

    @functools.cached_property
    def packed_x3(self) -> tuple:
        """:meth:`weights` for the bf16x3 build: each matrix
        :func:`pack_x3`-ed, in the f32 layout's bytes and offsets."""
        return self._packs(pack_x3)

    def _packs(self, pack) -> tuple:
        def flat(ts):
            return torch.cat([pack(t).reshape(-1) for t in ts]).contiguous()

        return (pack(self.env_w), pack(self.env_wT), flat(self.lat),
                flat([w.T for w in self.lat]), flat(self.mix), flat([w.T for w in self.mix]))

    def layout(self, build: str) -> tuple:
        """The launcher's weights (:meth:`weights`' order) for ``build``
        (:func:`build_for`); the packed copies are made at the first launch
        that wants them and go with this object when a leaf changes."""
        if build == "tf32x3":
            return self.weights()
        return self.packed_x3 if build == "bf16x3" else self.packed

    @functools.cached_property
    def meta_bf16(self) -> torch.Tensor:
        """:attr:`meta` with the 3j weights and the mix norms rounded to
        bf16, for the bf16 build: JAX applies them as weakly typed Python
        floats to bf16 values."""
        m = np.frombuffer(self.meta.cpu().numpy().tobytes(), _META_DTYPE).copy()
        for f in ("w", "rownorm"):
            m[f] = torch.from_numpy(m[f]).to(torch.bfloat16).float().numpy()
        return torch.from_numpy(np.frombuffer(m.tobytes(), np.int32).copy()).to(self.meta.device)


def pack_pairs(w: torch.Tensor) -> torch.Tensor:
    """A (Kd, M) weight matrix (Kd even) as the bf16 kernels read it: Kd/2
    rows of M int32 words, word (k2, m) holding bf16(w[2 k2, m]) in its low
    and bf16(w[2 k2 + 1, m]) in its high half (csrc/allegro_mma.cuh), the
    pairs of the k16 tensor-core fragments."""
    kd, m = w.shape
    if kd % 2:
        raise ValueError(f"pack_pairs: {kd} rows, want an even count")
    pairs = w.detach().to(torch.bfloat16).reshape(kd // 2, 2, m).transpose(1, 2)
    return pairs.reshape(kd // 2, 2 * m).view(torch.int32)


def pack_x3(w: torch.Tensor) -> torch.Tensor:
    """A (Kd, M) weight matrix (Kd even) as the bf16x3 kernels read it: the
    hi and lo parts of JAX's split (``hi = bf16(w)``, ``lo = bf16(w - hi)``)
    each :func:`pack_pairs`-ed, their word rows interleaved (row 2 k2 the
    hi pairs of rows 2 k2 and 2 k2 + 1, row 2 k2 + 1 their lo pairs): Kd
    rows of M int32 words, the f32 layout's bytes (csrc/allegro_mma.cuh)."""
    kd, m = w.shape
    w = w.detach().float()
    hi = w.to(torch.bfloat16).float()
    lo = (w - hi).to(torch.bfloat16).float()
    return torch.stack([pack_pairs(hi), pack_pairs(lo)], 1).reshape(kd, m)


def build_for(dtype: torch.dtype, mode: str | None = None) -> str:
    """The build of the layer body a launch at ``dtype`` takes in kernel
    ``mode`` (default: the policy's, ``prec.kernel_mode``): 'bf16' (bf16
    operands), or at f32 'tf32x3', 'bf16x3' or 'onepass' (a one-pass
    product on f32 operands)."""
    mode = mode or prec.kernel_mode(dtype)
    if mode not in prec.MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; one of {prec.MODES}")
    if dtype == torch.bfloat16:
        return "bf16"
    return "onepass" if mode == "bf16" else mode


def layer_leaves(layer: dict, lmax: int) -> tuple:
    """The JAX-layout leaves of one Allegro layer the kernels read."""
    return (layer["env_weight"], *layer["latent_mlp"]["w"],
            *(layer["mix"][f"l{l3}"] for l3 in range(lmax + 1)))


def _to_pmajor(w: torch.Tensor, c: int) -> torch.Tensor:
    """(c*P, Cout) c-major rows -> (P*c, Cout) p-major rows."""
    cp, cout = w.shape
    return w.reshape(c, cp // c, cout).transpose(0, 1).reshape(cp, cout)


@functools.lru_cache(maxsize=None)
def _row_tables(lmax: int, parity: bool):
    """Per output row r = l3^2 + k: (entries (p, i, j, w) of that row, l3)."""
    nz = _nonzeros(lmax, parity)
    rows = []
    for l3 in range(lmax + 1):
        for k in range(2 * l3 + 1):
            rows.append(
                (tuple((p, i, j, w) for (p, i, j, kk, w) in nz[l3] if kk == k), l3)
            )
    return tuple(rows)


@functools.lru_cache(maxsize=None)
def _meta_table(lmax, parity, c, cout, latd: tuple) -> np.ndarray:
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    rows = _row_tables(lmax, parity)
    if sum(len(ents) for ents, _ in rows) > _MAX_ENT:
        raise ValueError(f"l_max={lmax}, parity={parity} has more 3j entries than the kernel's table")
    m = np.zeros((), _META_DTYPE)
    mixoff = np.cumsum([0] + [p * c * cout for p in P])
    e = 0
    for r, (ents, l3) in enumerate(rows):
        m["rowstart"][r] = e
        m["rowP"][r] = P[l3]
        m["rowmix"][r] = mixoff[l3]
        m["rownorm"][r] = 1.0 / math.sqrt(P[l3] * c)
        for p, i, j, w in ents:
            m["ent"][e] = p | (i << 8) | (j << 16)
            m["w"][e] = w
            e += 1
    m["rowstart"][len(rows)] = e
    # the kernels' TP sums each path of a row in registers, one run each
    if any([p for p, *_ in ents] != sorted(p for p, *_ in ents) for ents, _ in rows):
        raise ValueError("a row's 3j entries are not ordered by path")
    m["n_ent"] = e
    m["latdim"][: len(latd)] = latd
    m["latoff"][: len(latd) - 1] = np.cumsum([0] + [a * b for a, b in zip(latd[:-1], latd[1:])])[:-1]
    m.setflags(write=False)  # memoised: every caller gets this one table
    return m


def prepare_layer(layer: dict, lmax: int, parity: bool) -> K1Weights:
    """Kernel-layout weights of one layer (see :class:`K1Weights`), made
    anew; :func:`k1_weights` is the cached accessor."""
    env_w = layer["env_weight"].detach()
    ns, c = env_w.shape
    lat = [w.detach() for w in layer["latent_mlp"]["w"]]
    lat[0] = torch.cat([lat[0][:ns], _to_pmajor(lat[0][ns:], c)], dim=0)
    mix = tuple(_to_pmajor(layer["mix"][f"l{l3}"].detach(), c) for l3 in range(lmax + 1))
    latd = [lat[0].shape[0]] + [w.shape[1] for w in lat]
    if len(latd) - 1 > _MAX_LAT or (lmax + 1) ** 2 > _MAX_D:
        raise ValueError("layer exceeds the kernel's table sizes")

    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts]).contiguous()

    meta = _meta_table(lmax, parity, c, mix[0].shape[1], tuple(latd))
    return K1Weights(
        env_w=env_w.contiguous(),
        env_wT=env_w.T.contiguous(),
        lat=tuple(w.contiguous() for w in lat),
        mix=mix,
        lat_flat=flat(lat),
        latT_flat=flat([w.T for w in lat]),
        mix_flat=flat(mix),
        mixT_flat=flat([w.T for w in mix]),
        meta=torch.from_numpy(np.frombuffer(meta.tobytes(), np.int32).copy()).to(env_w.device),
        lmax=lmax,
        parity=parity,
        leaves=layer_leaves(layer, lmax),
    )


def k1_weights(layer: dict, lmax: int, parity: bool) -> K1Weights:
    """K1's weights for the layer as its leaves stand now: made once and
    kept until a leaf is replaced or updated in place
    (``ops/weight_cache.py``)."""
    return LAYOUTS.get(("k1", lmax, parity), layer_leaves(layer, lmax),
                       lambda: prepare_layer(layer, lmax, parity))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the oracle of the kernel)
# ---------------------------------------------------------------------------


def fused_layer_reference(xt, Vt, yt, ut, w: K1Weights, K: int, inv_avg: float,
                          first_v: bool = False, last: bool = False, mode: str | None = None,
                          scalars: torch.dtype | None = None, x_env=None):
    """The same function as the kernel, in plain PyTorch on the same
    feature-major layout: xt (ns, E), Vt (D, C, E) or pT (C, E) when
    ``first_v``, yt (D, E), ut (1, E).  Returns xt' or (xt', Vt'); goes
    through torch autograd.  Its products (wz, the mix, the latent MLP) are
    ``prec.kmm`` in kernel ``mode`` (default: the policy's for the
    operands' dtype, ``prec.kernel_mode``); the env sum is an f32 sum
    under every mode.  The Python-float constants (1/sqrt(ns), 1/sqrt(avg),
    the 3j weights, the mix norms, the fan-in scales, the SiLU norm,
    1/sqrt(2)) apply as JAX applies them to values of dtype ``scalars``
    (default: the operands'; ``mlp.weak_scalar``): rounded at bf16.
    ``x_env`` (default: xt, the same values) is the x the env product
    reads, so that a caller may treat its cotangent apart."""
    mode = mode or prec.kernel_mode(xt.dtype)
    sd = scalars or xt.dtype

    def c(v):
        return weak_scalar(v, sd)

    ns, e = xt.shape
    d_dim = yt.shape[0]
    ch = w.env_w.shape[1]
    nc = e // K
    wz = prec.kmm(w.env_w.T.to(xt.dtype), xt if x_env is None else x_env, mode,
                  c(1.0 / math.sqrt(ns))) * ut  # (C, E)
    A = wz.unsqueeze(0) * yt.unsqueeze(1)  # (D, C, E)
    env = A.reshape(d_dim, ch, nc, K).sum(-1) * c(inv_avg)
    env_e = env.unsqueeze(-1).expand(d_dim, ch, nc, K).reshape(d_dim, ch, e)
    V = Vt.unsqueeze(0) * yt.unsqueeze(1) if first_v else Vt
    rows = _row_tables(w.lmax, w.parity)
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    out_rows = []
    inv = None
    for r, (ents, l3) in enumerate(rows[:1] if last else rows):
        acc = [None] * P[l3]
        for p, i, j, wv in ents:
            t = (c(wv) * V[i]) * env_e[j]
            acc[p] = t if acc[p] is None else acc[p] + t
        t_r = torch.cat([a if a is not None else V.new_zeros(ch, e) for a in acc], 0)
        if r == 0:
            inv = t_r  # (P0*C, E) p-major
        if not last:
            m = w.mix[l3].to(xt.dtype)
            out_rows.append(prec.kmm(m.T, t_r, mode, c(1.0 / math.sqrt(P[l3] * ch))))
    h = torch.cat([xt, inv], 0)
    for li, wl in enumerate(w.lat):
        h = prec.kmm(wl.to(xt.dtype).T, h, mode, c(1.0 / math.sqrt(wl.shape[0])))
        if li < len(w.lat) - 1:
            h = F.silu(h) * c(silu_norm_const())
    x_out = (xt + h * ut) * c(1.0 / math.sqrt(2.0))
    if last:
        return x_out
    return x_out, torch.stack(out_rows, 0)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def _bind(lib):
    lib.k1_meta_words.argtypes = []
    lib.k1_meta_words.restype = ctypes.c_int
    lib.k1_launch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_int),
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.k1_launch.restype = ctypes.c_int
    lib.k1_layout_bytes.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.k1_layout_bytes.restype = ctypes.c_int
    if lib.k1_meta_words() * 4 != _META_DTYPE.itemsize:
        raise RuntimeError("kernel table layout differs from the wrapper's")


_HEADERS = [CSRC / "allegro_layer.cuh", CSRC / "allegro_mma.cuh", CSRC / "allegro_tiles.cuh",
            CSRC / "mma_ptx.cuh"]
LIB = CudaLibrary("k1_fused_layer", [CSRC / "fused_layer.cu", *_HEADERS], _bind)
LIB_BF16 = CudaLibrary("k1_fused_layer_bf16",
                       [CSRC / "fused_layer_bf16.cu", CSRC / "fused_layer.cu", *_HEADERS], _bind)
LIB_BF16X3 = CudaLibrary("k1_fused_layer_bf16x3",
                         [CSRC / "fused_layer_bf16x3.cu", CSRC / "fused_layer.cu", *_HEADERS],
                         _bind)
LIB_ONEPASS = CudaLibrary("k1_fused_layer_onepass",
                          [CSRC / "fused_layer_onepass.cu", CSRC / "fused_layer.cu", *_HEADERS],
                          _bind)


# each build's (library, launch counts), looked up at each launch
BUILDS = {"tf32x3": (LIB, launches), "bf16": (LIB_BF16, launches_bf16),
          "bf16x3": (LIB_BF16X3, launches_bf16x3), "onepass": (LIB_ONEPASS, launches_onepass)}


def count(counts: LaunchCounts, bwd: bool) -> None:
    if bwd:
        counts.bwd += 1
    else:
        counts.fwd += 1


def _launch(bwd: bool, dims, inv_avg, ptrs, device, build: str):
    lib, counts = BUILDS[build]
    lib = lib.load()
    arr = (ctypes.c_ulonglong * 19)(*ptrs)
    dm = (ctypes.c_int * 12)(*dims)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.k1_launch(int(bwd), arr, dm, ctypes.c_float(inv_avg), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K1 ({build}) {'backward' if bwd else 'forward'} "
                           f"launch failed (code {rc})")
    count(counts, bwd)


def launch_scalars(w: K1Weights, build: str, inv_avg: float) -> tuple:
    """(meta table, 1/sqrt(avg)) of a launch: for the bf16 build rounded
    as JAX's weak typing rounds them (``meta_bf16``, ``mlp.weak_scalar``)."""
    if build == "bf16":
        return w.meta_bf16, weak_scalar(inv_avg, torch.bfloat16)
    return w.meta, inv_avg


def kernel_dims(w: K1Weights, d: int, K: int, e: int, first_v: bool, last: bool) -> list:
    """The launcher's 12 layer dims (``k1_params``, csrc/allegro_layer.cuh)."""
    ns, c, cout, latd = w.dims
    hidden = latd[1:-1]
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    return [ns, c, cout, d, K, e, len(w.lat), int(first_v), int(last),
            max(hidden) if hidden else 4, max(P) * c, latd[0]]


def _kernel_fwd(xt, Vt, yt, ut, w, K, inv_avg, first_v, last, mode=None):
    """One forward launch of the build of ``mode`` (default: the policy's)."""
    build = build_for(xt.dtype, mode)
    cout = w.mix[0].shape[1]
    e = xt.shape[1]
    xo = torch.empty_like(xt)
    vo = None if last else torch.empty((yt.shape[0], cout, e), dtype=xt.dtype, device=xt.device)
    meta, ia = launch_scalars(w, build, inv_avg)
    ptrs = [xt.data_ptr(), Vt.data_ptr(), yt.data_ptr(), ut.data_ptr(),
            *(t.data_ptr() for t in w.layout(build)), 0, 0, meta.data_ptr(), xo.data_ptr(),
            0 if last else vo.data_ptr(), 0, 0, 0, 0]
    _launch(False, kernel_dims(w, yt.shape[0], K, e, first_v, last), ia, ptrs, xt.device, build)
    return xo if last else (xo, vo)


def _kernel_bwd(xt, Vt, yt, ut, w, K, inv_avg, first_v, last, dxo, dvo, mode=None):
    """One backward launch of the build of ``mode`` (default: the policy's)."""
    build = build_for(xt.dtype, mode)
    dx = torch.empty_like(xt)
    dV = torch.empty_like(Vt)
    dY = torch.empty_like(yt)
    du = torch.empty_like(ut)
    meta, ia = launch_scalars(w, build, inv_avg)
    ptrs = [xt.data_ptr(), Vt.data_ptr(), yt.data_ptr(), ut.data_ptr(),
            *(t.data_ptr() for t in w.layout(build)), dxo.data_ptr(),
            0 if last else dvo.data_ptr(), meta.data_ptr(), 0, 0,
            dx.data_ptr(), dV.data_ptr(), dY.data_ptr(), du.data_ptr()]
    _launch(True, kernel_dims(w, yt.shape[0], K, xt.shape[1], first_v, last), ia, ptrs,
            xt.device, build)
    return dx, dV, dY, du


class _FusedLayer(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes what it needs from (x, V, Y, u), as the TPU kernel
    does, and hands back NaN-filled weight cotangents."""

    @staticmethod
    def forward(ctx, xt, Vt, yt, ut, w, K, inv_avg, first_v, last, *weights):
        mode = prec.kernel_mode(xt.dtype)
        ctx.cfg = (w, K, inv_avg, first_v, last, mode)
        ctx.save_for_backward(xt, Vt, yt, ut)
        if xt.is_cuda:
            return _kernel_fwd(xt, Vt, yt, ut, w, K, inv_avg, first_v, last, mode)
        return fused_layer_reference(xt, Vt, yt, ut, w, K, inv_avg, first_v, last, mode)

    @staticmethod
    def backward(ctx, dxo, dvo=None):
        w, K, inv_avg, first_v, last, mode = ctx.cfg
        xt, Vt, yt, ut = ctx.saved_tensors
        if xt.is_cuda:
            grads = _kernel_bwd(xt, Vt, yt, ut, w, K, inv_avg, first_v, last,
                                dxo.contiguous(), None if last else dvo.contiguous(), mode)
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (xt, Vt, yt, ut)]
                out = fused_layer_reference(*ins, w, K, inv_avg, first_v, last, mode)
                outs, cots = ((out,), (dxo,)) if last else (out, (dxo, dvo))
                grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ins)]
        nan_w = [torch.full_like(t, float("nan")) for t in w.tensors()]
        return (*grads, None, None, None, None, None, *nan_w)


def fused_layer(xt, Vt, yt, ut, w: K1Weights, K: int, avg_num_neighbors: float,
                first_v: bool = False, last: bool = False):
    """One Allegro layer on the feature-major TABLE layout.

    xt (ns, E); Vt (D, C, E), or the (C, E) tensor embedding pT when
    ``first_v`` (V0 = pT * Y is built inside); yt (D, E); ut (1, E);
    E = n_centers * K.  Returns xt' (``last``: no V output) or (xt', Vt').
    CUDA tensors launch the kernel (contiguous, and all four f32, or all four
    bf16 for the bf16 build; the weights are the tree's f32 leaves either
    way); CPU tensors take :func:`fused_layer_reference` at their dtype."""
    ns, e = xt.shape
    d_dim = yt.shape[0]
    c = w.env_w.shape[1]
    want_v = (c, e) if first_v else (d_dim, c, e)
    if tuple(Vt.shape) != want_v or tuple(yt.shape) != (d_dim, e) or tuple(ut.shape) != (1, e):
        raise ValueError(f"fused_layer shapes: x {tuple(xt.shape)}, V {tuple(Vt.shape)} "
                         f"(want {want_v}), Y {tuple(yt.shape)}, u {tuple(ut.shape)}")
    if w.env_w.shape[0] != ns or d_dim != (w.lmax + 1) ** 2 or K < 1 or e % K:
        raise ValueError(f"fused_layer: ns={ns}, D={d_dim}, K={K}, E={e} do not fit the layer")
    ts = (xt, Vt, yt, ut, *w.tensors())
    if any(t.device != xt.device for t in ts):
        raise ValueError("fused_layer: all tensors must be on one device")
    if xt.is_cuda:
        if (xt.dtype not in (torch.float32, torch.bfloat16)
                or any(t.dtype != xt.dtype for t in (Vt, yt, ut))
                or any(t.dtype != torch.float32 for t in w.tensors())):
            raise TypeError("fused_layer: the CUDA kernel takes x, V, Y and u all float32 or all "
                            "bfloat16, and float32 weights")
        if any(not t.is_contiguous() for t in (xt, Vt, yt, ut)):
            raise ValueError("fused_layer: CUDA inputs must be contiguous")
    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    return _FusedLayer.apply(xt, Vt, yt, ut, w, K, inv_avg, first_v, last, *w.tensors())

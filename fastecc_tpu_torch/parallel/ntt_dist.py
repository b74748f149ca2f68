"""Mesh-sharded four-step NTT on ``torch.distributed`` (the port's
counterpart of ``parallel/ntt_dist.py``).

The same four-step decomposition as the reference (n = r + R*c,
k = k_c + C*k_r, natural order in and out, 'coeff' axis size D), each
``shard_map`` body an SPMD function of this rank's local shard:

  local shard           [C/D, R, L]   (natural rows, a c-slab per rank)
  exchange #1      ->   [C, R/D, L]   localize the c axis
  local NTT_C (axis 0)               K1 -> K3 (ntt.ntt_auto)
  twiddle w_N^(k_c * r)              host table, this rank's r columns
  exchange #2      ->   [C/D, R, L]   localize the r axis
  local NTT_R (axis 1)               K1 -> K3
  exchange #3      ->   [R/D, C, L] = [N/D, L], natural k-slabs

Lanes (the last axis) shard over the ``block`` axis with no
communication. The exchanges are ``all_to_all_single`` over the coeff
axis's process group on an int32 view (Gloo refuses uint32); each is
counted in :data:`COLLECTIVES`, where the reference counts all_to_all in
the lowered HLO. The table multiplies (four-step twiddle, coset table,
the decode's l(w^j), x*d/dx and Forney, and the 1/N scale), which the
reference computes in jnp outside any kernel, are one launch each of the
hand-written ``csrc/table.cu`` on a CUDA tensor (u32 in and out, a table
word a row), and on a CPU tensor the plain version: ``ntt.mul_prepared``'s
torch ops in int64 carriers, in row chunks that bound their temporaries.
:data:`TABLE_MULS` counts them on both routes, :data:`LAUNCHES` the
kernel's launches.

While a profiler records, :func:`ntt_sharded` and the codec's entries
run inside a span ``fecc.dist.<name>``, an exchange's pack and launch
and then its unpack each inside ``fecc.dist.exchange`` (two spans an
exchange, so the overlapped form's are spanned too), each table multiply
inside ``fecc.dist.mul_table`` and each 1/N scale inside
``fecc.dist.scale`` (``utils.profiling.scope``); the local transforms'
passes carry their own ``fecc.pass.*`` spans.

The transposed hand-off (``output_transposed`` / ``input_transposed``)
skips the third exchange of a transform and the first of the next, so
the RS encode and the erasure decode each cost 4 exchanges, not 6.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import gf
from ..fields import FieldSpec
from ..interop import as_tensor
from ..kernels import _build
from ..ntt import (_four_step_twiddles, _log2, mul_prepared, ntt_auto,
                   prepare_consts)
from ..rs import _check_kn
from ..utils import profiling
from .mesh import rank_device

# Exchanges issued, and the bytes this rank sent to other ranks in them,
# as ntt_mfa.LAUNCHES counts kernels.
COLLECTIVES = {"all_to_all": 0, "all_to_all_bytes": 0}

# Table multiplies issued (and the elements they multiplied), and 1/N
# scales, counted apart from COLLECTIVES, which the tests hold to the
# reference's count.
TABLE_MULS = {"mul_table": 0, "mul_table_elems": 0, "scale": 0}

# Launches of ``csrc/table.cu`` (the card route of the table multiplies
# and the 1/N), apart from ntt_mfa.LAUNCHES, whose keys are the kernels
# the port's passes replace.
LAUNCHES = {"mul_table": 0}

# Elements per torch-op table multiply (the CPU route): bounds its int64
# temporaries (~10 live carriers of 8 bytes an element).
_MUL_CHUNK = 1 << 24


def reset_collectives() -> None:
    """Zero :data:`COLLECTIVES`, :data:`TABLE_MULS` and :data:`LAUNCHES`."""
    for counts in (COLLECTIVES, TABLE_MULS, LAUNCHES):
        for k in counts:
            counts[k] = 0


def _span(name: str):
    """Run the decorated entry inside the span ``name`` (on only while a
    profiler records)."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with profiling.scope(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def _coeff(mesh) -> tuple[int, int]:
    """(D, this rank's index on the coeff axis)."""
    return mesh.shape[0], mesh.get_local_rank("coeff")


def _on_rank(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else as_tensor(x, rank_device())


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint32)


class _Exchange:
    """One ``all_to_all`` in flight (see :func:`_exchange`)."""

    def __init__(self, t, mesh, split_axis: int, concat_axis: int):
        d = mesh.shape[0]
        s = tuple(t.shape)
        if s[split_axis] % d:
            raise ValueError(f"axis {split_axis} of {s} does not split "
                             f"over {d} ranks")
        parts = s[:split_axis] + (d, s[split_axis] // d) + s[split_axis + 1:]
        with profiling.scope("fecc.dist.exchange"):
            # [D, ...]: the chunk for destination i is send[i], contiguous
            send = t.view(torch.int32).reshape(parts).movedim(
                split_axis, 0).contiguous()
            self.recv = torch.empty_like(send)
            self.concat = concat_axis
            group = mesh.get_group("coeff")
            COLLECTIVES["all_to_all"] += 1
            COLLECTIVES["all_to_all_bytes"] += send.numel() * 4 * (d - 1) // d
            self.work = dist.all_to_all_single(self.recv, send, group=group,
                                               async_op=True)
        self._send = send   # alive until the exchange completes

    def wait(self) -> torch.Tensor:
        with profiling.scope("fecc.dist.exchange"):
            self.work.wait()
            self._send = None
            r = self.recv                  # [D, ...]: r[i] came from rank i
            d, rest = r.shape[0], tuple(r.shape[1:])
            c = self.concat
            out = r.movedim(0, c).reshape(rest[:c] + (d * rest[c],)
                                          + rest[c + 1:])
            return _u32(out.contiguous())


def _exchange(t: torch.Tensor, mesh, split_axis: int, concat_axis: int
              ) -> torch.Tensor:
    """``jax.lax.all_to_all(t, "coeff", split_axis, concat_axis,
    tiled=True)`` on this rank's local ``t``: axis ``split_axis`` is cut
    into D chunks, chunk i goes to coeff rank i, and the chunks received
    are laid side by side along ``concat_axis`` in source-rank order.
    ``all_to_all_single`` splits and joins dim 0 only, so the split axis
    is moved to the front as [D, ...] before the exchange and the source
    axis into the concat axis after it.

    The reference's three exchanges, on rank j, with rank i's input
    written x_i (a < the output's rows, b < its columns, l a lane):

      #1 ([C/D, R, L] -> [C, R/D, L]; split 1, concat 0):
         out[i*C/D + a, b, l] = x_i[a, j*R/D + b, l]
      #2 ([C, R/D, L] -> [C/D, R, L]; split 0, concat 1):
         out[a, i*R/D + b, l] = x_i[j*C/D + a, b, l]
      #3 ([R, C/D, L] -> [R/D, C, L]; split 0, concat 1):
         out[a, i*C/D + b, l] = x_i[j*R/D + a, b, l]
    """
    return _Exchange(t, mesh, split_axis, concat_axis).wait()


def _local_ntt(y: torch.Tensor, field: FieldSpec, inverse: bool
               ) -> torch.Tensor:
    """This rank's NTT along axis 0 of a [T, A, L] block: the trailing
    axes are lanes, flattened into one [T, A*L] unscaled transform
    through ``ntt.ntt_auto`` (K1 -> K3 on a CUDA tensor, their plain
    versions on a CPU tensor, the torch-op Stockham transform below order
    4). The reference picks Pallas from the mesh's platform; the port
    picks from the tensor's device, as ``ntt_auto`` does."""
    t, a, lanes = y.shape
    out = ntt_auto(y.reshape(t, a * lanes), field, inverse=inverse,
                   scale=False)
    return out.reshape(t, a, lanes)


def _by_rows(y: torch.Tensor, fn) -> torch.Tensor:
    """``fn(y[i0:i1], i0, i1)`` (u32 in, u32 out) over row chunks of at
    most :data:`_MUL_CHUNK` elements, into one u32 tensor like ``y``."""
    out = torch.empty_like(y.view(torch.int32))
    step = max(1, _MUL_CHUNK // max(1, y[0].numel()))
    for i0 in range(0, y.shape[0], step):
        i1 = min(i0 + step, y.shape[0])
        out[i0:i1].copy_(fn(y[i0:i1], i0, i1).view(torch.int32))
    return _u32(out)


def _on_card(y: torch.Tensor) -> bool:
    """True for the kernel route (a CUDA tensor), False for the plain
    version (a CPU tensor)."""
    return y.device.type != "cpu"


def _check_table(y: torch.Tensor, t: torch.Tensor) -> int:
    """The rows of ``y`` (its leading axes flattened) once ``t`` is a
    contiguous u32 table on y's device of a word a row, or of one word."""
    lanes = y.shape[-1]
    rows = y.numel() // lanes if lanes else 0
    if (t.dtype != torch.uint32 or t.device != y.device
            or not t.is_contiguous() or t.dim() != 1
            or t.numel() not in (1, rows)):
        raise ValueError(f"the table multiply takes a contiguous u32 table "
                         f"of 1 or {rows} words on {y.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return rows


def _mul_rows(field: FieldSpec, y: torch.Tensor, t: torch.Tensor
              ) -> torch.Tensor:
    """One launch of ``csrc/table.cu`` on the card: y * t mod p, u32 in
    and out, y's last axis the lanes and its other axes flattened into
    rows; ``t`` a prepared u32 word for each row, or one word for every
    row. It opens no span of its own: the caller's ``fecc.dist.mul_table``
    or ``fecc.dist.scale`` launches it."""
    y = _u32(y.view(torch.int32).contiguous())
    rows = _check_table(y, t)
    out = _u32(torch.empty_like(y.view(torch.int32)))
    with torch.cuda.device(y.device):
        _build.call("fecc_mul_table", 0 if field.use_mont else 1,
                    y.data_ptr(), out.data_ptr(), rows, y.shape[-1],
                    t.data_ptr(), int(t.numel() == rows),
                    torch.cuda.current_stream(y.device).cuda_stream)
    LAUNCHES["mul_table"] += 1
    return out


def _mul_plain(field: FieldSpec, y: torch.Tensor, t: torch.Tensor
               ) -> torch.Tensor:
    """The plain version of :func:`_mul_rows`: ``mul_prepared``'s torch
    ops in int64 carriers over row chunks of y viewed [rows, lanes]."""
    _check_table(y, t)
    y2 = _u32(y.view(torch.int32).reshape(-1, y.shape[-1]))
    tt = t.expand(y2.shape[0])
    out = _by_rows(y2, lambda v, i0, i1: mul_prepared(field, v,
                                                      tt[i0:i1, None]))
    return _u32(out.view(torch.int32).reshape(y.shape))


def _mul_table(field: FieldSpec, y: torch.Tensor, table: torch.Tensor
               ) -> torch.Tensor:
    """y * table mod p: ``table`` a prepared u32 vector of a word for
    each row of y's leading axes (:func:`_table_cols`, the decode's
    [n/D] tables). On a card one kernel launch (:func:`_mul_rows`), on a
    CPU tensor its plain version (:func:`_mul_plain`)."""
    with profiling.scope("fecc.dist.mul_table"):
        TABLE_MULS["mul_table"] += 1
        TABLE_MULS["mul_table_elems"] += y.numel()
        if _on_card(y):
            return _mul_rows(field, y, table)
        return _mul_plain(field, y, table)


@functools.lru_cache(maxsize=64)
def _inv_on(field: FieldSpec, n: int, device: str) -> torch.Tensor:
    """1/n prepared for the table multiply: one u32 word on ``device``
    (cached)."""
    return as_tensor(prepare_consts(field, np.array([field.inv_host(n)])),
                     device)


def _scale(field: FieldSpec, y: torch.Tensor, n: int) -> torch.Tensor:
    with profiling.scope("fecc.dist.scale"):
        TABLE_MULS["scale"] += 1
        if _on_card(y):
            return _mul_rows(field, y, _inv_on(field, n, str(y.device)))
        inv_n = field.inv_host(n)
        return _by_rows(y, lambda v, i0, i1: gf.mul_const(field, v, inv_n))


@functools.lru_cache(maxsize=64)
def _table_cols(build, args: tuple, row, r_dim: int, cd: int, j: int,
                device: str) -> torch.Tensor:
    """Rank j's C slice of the host table ``build(*args)`` (its row
    ``row`` unless None) viewed [R, C], as one contiguous u32 [R * C/D]
    vector on ``device``: a word for each row of the multiplied
    [R, C/D, L], the table :func:`_mul_table` takes (cached; nothing is
    rebuilt a call)."""
    t = np.asarray(build(*args))
    t = t if row is None else t[row]
    cut = t.reshape(r_dim, -1)[:, j * cd:(j + 1) * cd]
    return as_tensor(np.ascontiguousarray(cut, np.uint32).reshape(-1),
                     device)


def _twiddle_cols(field: FieldSpec, n: int, c_dim: int, inverse: bool,
                  d: int, j: int, device) -> torch.Tensor:
    """This rank's r columns of the four-step table w_N^(+-k_c * r), a
    word for each of the [C, R/D] rows (:func:`_table_cols`)."""
    return _table_cols(_four_step_twiddles, (field.name, n, c_dim, inverse),
                       None, c_dim, n // c_dim // d, j, str(device))


def _cols_of(table: torch.Tensor, r_dim: int, cd: int, d: int, j: int):
    """This rank's C slice of an [N] table viewed [R, C]: [R, C/D, 1]."""
    return table.reshape(r_dim, cd * d)[:, j * cd:(j + 1) * cd, None]


def _split_dims(n: int, d: int, c_dim: int | None):
    t = _log2(n)
    if c_dim is None:
        c_dim = max(d, 1 << (t // 2))
    r_dim = n // c_dim
    if c_dim * r_dim != n:
        raise ValueError(f"c_dim {c_dim} does not divide N={n}")
    if c_dim % d or r_dim % d:
        raise ValueError(
            f"coeff axis {d} must divide both C={c_dim} and R={r_dim} "
            f"(need N >= D^2; N={n}, D={d})")
    return c_dim, r_dim


@_span("fecc.dist.ntt_sharded")
def ntt_sharded(x, field: FieldSpec, mesh, inverse: bool = False,
                c_dim: int | None = None, scale: bool = True,
                input_transposed: bool = False,
                output_transposed: bool = False) -> torch.Tensor:
    """N-point NTT along axis 0 of a [N, L] array sharded (coeff, block):
    ``x`` is this rank's local [N/Dc, L/Db] shard and the result is its
    local shard of the transform, bit for bit the single-device
    ``ntt.ntt_auto``'s (natural order in and out).

    Transposed hand-off: ``output_transposed=True`` skips the last
    exchange and returns the natural result viewed [R, C, L] with the
    inner axis sharded (local [R, C/Dc, L/Db]); ``input_transposed=True``
    takes exactly that layout ([A, B/Dc, L/Db] of a global [A, B, L],
    logical m = A-major) and skips its first exchange by splitting C = A,
    R = B. The iNTT -> coset NTT seam of the encode and the iNTT -> NTT
    seam of the decode save two of six exchanges that way. Dc == 1 runs
    the single-device transform on the local lanes."""
    x = _on_rank(x)
    d, j = _coeff(mesh)
    lanes = x.shape[-1]
    if input_transposed:
        if x.dim() != 3:
            raise ValueError("the transposed layout is [A, B/Dc, L]")
        c_in, r_in = x.shape[0], x.shape[1] * d
        if c_dim is not None and c_dim != c_in:
            raise ValueError(f"c_dim {c_dim} != the transposed input's "
                             f"A = {c_in}")
        c_dim, r_dim = c_in, r_in
        n = c_dim * r_dim
        if c_dim % d or r_dim % d:
            raise ValueError(f"coeff axis {d} must divide both axes of "
                             f"the transposed input ({c_dim}, {r_dim})")
    else:
        n = x.shape[0] * d
        if d > 1:
            c_dim, r_dim = _split_dims(n, d, c_dim)

    if d == 1:
        out = ntt_auto(x.view(torch.int32).reshape(n, lanes).view(
            torch.uint32), field, inverse=inverse, scale=False)
        if inverse and scale:
            out = _scale(field, out, n)
        if output_transposed:
            cd = c_dim or 1 << (_log2(n) // 2)
            return out.reshape(n // cd, cd, lanes)
        return out

    if input_transposed:
        y = x                                            # [C, R/D, L]
    else:
        y = _exchange(x.reshape(c_dim // d, r_dim, lanes), mesh, 1, 0)
    y = _local_ntt(y, field, inverse)                    # c -> k_c
    y = _mul_table(field, y, _twiddle_cols(field, n, c_dim, inverse, d, j,
                                           y.device))   # w_N^(k_c * r)
    y = _exchange(y, mesh, 0, 1)                         # [C/D, R, L]
    y = _u32(y.view(torch.int32).movedim(1, 0).contiguous())  # [R, C/D, L]
    y = _local_ntt(y, field, inverse)                    # r -> k_r
    if output_transposed:
        return _scale(field, y, n) if inverse and scale else y
    y = _exchange(y, mesh, 0, 1)                         # [R/D, C, L]
    # the local slab is k = k_c + C*k_r for this rank's k_r: row-major
    # it is the natural contiguous k-slab
    out = y.reshape((r_dim // d) * c_dim, lanes)
    return _scale(field, out, n) if inverse and scale else out


def ntt_sharded_overlap(x, field: FieldSpec, mesh, inverse: bool = False,
                        c_dim: int | None = None, scale: bool = True,
                        chunks: int = 2) -> torch.Tensor:
    """:func:`ntt_sharded` with the exchanges overlapped with the local
    transforms: the local lanes split into ``chunks`` slices, and each
    phase issues chunk i+1's exchange (``async_op=True``) before
    transforming chunk i, then waits for it. The same bits as
    :func:`ntt_sharded`."""
    x = _on_rank(x)
    d, j = _coeff(mesh)
    n, lanes = x.shape[0] * d, x.shape[1]
    if d == 1 or chunks <= 1:
        return ntt_sharded(x, field, mesh, inverse=inverse, c_dim=c_dim,
                           scale=scale)
    c_dim, r_dim = _split_dims(n, d, c_dim)
    if lanes % chunks:
        raise ValueError(f"local lanes {lanes} must split into {chunks} "
                         f"chunks")
    tw = _twiddle_cols(field, n, c_dim, inverse, d, j, x.device)
    w = lanes // chunks
    x3 = x.view(torch.int32).reshape(c_dim // d, r_dim, lanes)
    cs = [_u32(x3[:, :, i * w:(i + 1) * w]) for i in range(chunks)]
    # phase 1: chunk i+1's first exchange in flight while i transforms
    nxt = _Exchange(cs[0], mesh, 1, 0)
    mids = []
    for i in range(chunks):
        cur = nxt
        nxt = _Exchange(cs[i + 1], mesh, 1, 0) if i + 1 < chunks else None
        y = _local_ntt(cur.wait(), field, inverse)
        mids.append(_mul_table(field, y, tw))
    # phase 2: the same for the second exchange and the row transforms
    nxt = _Exchange(mids[0], mesh, 0, 1)
    outs = []
    for i in range(chunks):
        cur = nxt
        nxt = _Exchange(mids[i + 1], mesh, 0, 1) if i + 1 < chunks else None
        y = _u32(cur.wait().view(torch.int32).movedim(1, 0).contiguous())
        y = _exchange(_local_ntt(y, field, inverse), mesh, 0, 1)
        outs.append(y.view(torch.int32).reshape((r_dim // d) * c_dim, w))
    out = _u32(torch.cat(outs, dim=1))
    return _scale(field, out, n) if inverse and scale else out


@_span("fecc.dist.encode_parity_sharded")
def encode_parity_sharded(data, field: FieldSpec, mesh,
                          n: int | None = None) -> torch.Tensor:
    """Sharded RS parity: iNTT_k -> coset twiddle -> NTT_k per coset, on
    this rank's local [k/Dc, L/Db] data shard; the local shard of
    ``rs.encode_parity``'s rows (row order included).

    The iNTT hands its result to each coset NTT in the transposed layout,
    so the c = 2 encode runs 4 exchanges (2 a transform). The iNTT's k^-1
    is folded into the coset table (``rs._coset_twiddles_scaled``), whose
    [k] rows are viewed [R, C] and cut to this rank's C slice."""
    from ..rs import _coset_twiddles_scaled

    data = _on_rank(data)
    d, j = _coeff(mesh)
    k = data.shape[0] * d
    n = 2 * k if n is None else n
    _check_kn(k, n)
    c = n // k
    lanes = data.shape[1]
    coeffs_t = ntt_sharded(data, field, mesh, inverse=True, scale=False,
                           output_transposed=True)       # [R, C/D, L]
    r_dim, cd = coeffs_t.shape[0], coeffs_t.shape[1]
    cosets = []
    for r in range(1, c):
        tws = _table_cols(_coset_twiddles_scaled, (field.name, n, k), r - 1,
                          r_dim, cd, j, str(coeffs_t.device))
        prod = _mul_table(field, coeffs_t, tws)
        cosets.append(ntt_sharded(prod, field, mesh,
                                  input_transposed=True).view(torch.int32))
    stacked = torch.stack(cosets, dim=1)                 # [k/D, c-1, L]
    return _u32(stacked.reshape((n - k) // d, lanes))


@_span("fecc.dist.decode_prepared_sharded")
def decode_prepared_sharded(codeword, mask, l_eval_prep, lp_inv_prep,
                            field: FieldSpec, mesh) -> torch.Tensor:
    """Sharded erasure decode on this rank's local shards: the codeword
    [n/Dc, L/Db] and the [n/Dc] rows of the tables of
    ``decode.prepare_decode_tables`` (sharded on coeff, whole on every
    block rank). The same math as ``decode.decode_prepared``: x l(w^j),
    iNTT_n, x m (the unshifted x*d/dx), NTT_n, x inv(x l'(w^j)), then
    where(mask, recovered, codeword); the two transforms meet in the
    transposed layout, so the decode runs 4 exchanges."""
    from ..decode import _xderiv_consts

    cw = _on_rank(codeword)
    d, j = _coeff(mesh)
    n = cw.shape[0] * d
    mask, lp, ip = (_on_rank(t) for t in (mask, l_eval_prep, lp_inv_prep))
    h_eval = _mul_table(field, cw, lp)
    h_coeffs_t = ntt_sharded(h_eval, field, mesh, inverse=True,
                             output_transposed=True)     # [R, C/D, L]
    r_dim, cd = h_coeffs_t.shape[0], h_coeffs_t.shape[1]
    dx = _table_cols(_xderiv_consts, (field.name, n), None, r_dim, cd, j,
                     str(cw.device))
    h_der_t = _mul_table(field, h_coeffs_t, dx)
    hp_eval = ntt_sharded(h_der_t, field, mesh, input_transposed=True)
    recovered = _mul_table(field, hp_eval, ip)
    keep = (mask.view(torch.int32) == 1)[:, None]
    return _u32(torch.where(keep, recovered.view(torch.int32),
                            cw.view(torch.int32)))


@_span("fecc.dist.decode_sharded")
def decode_sharded(codeword, erased_idx, field: FieldSpec, mesh
                   ) -> torch.Tensor:
    """Full sharded decode: the locator tables from
    ``decode.prepare_decode_tables(erased_idx, n, field)`` on this rank's
    device (every rank builds them whole, as the reference builds them on
    the host), cut to this rank's rows, then
    :func:`decode_prepared_sharded`. ``erased_idx`` holds host values."""
    from ..decode import prepare_decode_tables

    cw = _on_rank(codeword)
    d, j = _coeff(mesh)
    rows = cw.shape[0]
    tables = prepare_decode_tables(np.asarray(erased_idx), rows * d, field,
                                   device=cw.device)
    mask, lp, ip = (t[j * rows:(j + 1) * rows] for t in tables)
    return decode_prepared_sharded(cw, mask, lp, ip, field, mesh)

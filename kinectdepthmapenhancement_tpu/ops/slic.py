"""SLIC superpixel family: base (SP), depth-adaptive (DASP), normal-adaptive (NASP).

JAX re-design of SuperpixelSegmentation / DepthAdaptiveSuperpixel /
NormalAdaptiveSuperpixel (reference SuperpixelSegmentation/*.cu).  The CUDA
structure (one block per pixel searching neighbouring clusters; one block per
cluster reducing a window) becomes:

  * assignment: a statically unrolled loop over the cluster-grid neighbourhood
    (4x4 for SP/DASP, 8x8 for NASP), each step a [K]-table gather by the
    pixel's current cluster coordinates + vectorised distance formula,
    running argmin with first-occurrence tie-break (== the reference's
    shared-memory tree reduction, which keeps the lowest thread id on ties);
  * cluster update: masked segment-sums over pixel features with the exact
    window restriction of the reference (pixels outside the +-window around
    the old cluster centre do not contribute), computed as one-hot matmul /
    segment_sum on the flattened image.

Fast paths (semantics-preserving):
  * first iteration: labels ARE the grid init, so a pixel's candidate
    clusters are a pure function of its grid cell — candidate features are
    BROADCAST per cell (zero gathers), and the post-assignment labels are
    drawn from the cell's (2r)^2-candidate set, so update gathers/segment
    sums route through a cell-local one-hot [rows, cols, P, n] instead of a
    [H*W, K] one (_CellIndex; ~K/n times less one-hot traffic and matmuls);
  * seed gradients are only consumed inside the window x window seed blocks
    around the grid centres, and the 11x11 gradient support of those blocks
    never leaves a cell when (window/2 + 5) fits inside half a cell — so the
    gradient is computed on the [rows*(window+10), cols*(window+10)]
    sub-grid (6-20%% of the image) and results are bit-identical.

Distance formulas are replicated exactly per variant:
  SP   (SuperpixelSegmentation.cu:197-206):
       cd * sc/(ss+sc) + pd * ss/(ss+sc),  pd = |dpix| * S^2
  DASP (DepthAdaptiveSuperpixel.cu:206-219):
       cd*(sc/T)^2 + pd*(ss/T)^2 + |dz|*(sd/T)^2,      T = ss+sc+sd
  NASP (NormalAdaptiveSuperpixel.cu:223-258):
       ... + 255^2*(1-max(0, n.nc)) * (sn/T)^2,        T = ss+sc+sd+sn

Documented bug-fidelity decisions (SURVEY.md §2 items a-d):
  (a) the seed-gradient kernels index the comparison pixel with loop offsets
      used as absolute coordinates (out-of-bounds reads) — FIXED here to the
      clamped window neighbours the code obviously intended;
  (b) the seed blue channel is stored as R+2 — FIXED (real blue channel);
  (c) the cluster-centre reprojection bounds test `pixel.y <= height` is
      always true, so the reprojection branch is dead and the stored pixel
      centre is always the 2-D centroid — REPLICATED (we always use the
      2-D centroid, like the reference actually computes);
  (d) the NASP normal distance is uninitialised when either normal is
      invalid — FIXED to 0.

The per-iteration D2H label copies of the reference (e.g.
DepthAdaptiveSuperpixel.cu:587) have no equivalent: everything stays on device.
"""

from __future__ import annotations


from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from kinectdepthmapenhancement_tpu.core.buffer2d import VALID_DEPTH_MM
from kinectdepthmapenhancement_tpu.core.config import GridParams, SLICParams
from kinectdepthmapenhancement_tpu.ops import tables

INIT_DISTANCE = 999999.9
INVALID_NORMAL = -1.0

_GRAD_MARGIN = 5  # the seed gradient's 11x11 window half-width

_FORCE_CELL: Optional[bool] = None  # None | True | False (tests pin a path)


def force_cell(mode: Optional[bool]) -> None:
    global _FORCE_CELL
    _FORCE_CELL = mode


def _use_cell() -> bool:
    if _FORCE_CELL is not None:
        return _FORCE_CELL
    return tables.use_onehot()


class Clusters(NamedTuple):
    """Cluster table [K, ...]; the reference's `superpixel` struct + the
    DASP/NASP side tables (centers, normals, variance)."""

    rgb: jnp.ndarray       # [K, 3] f32, integer-valued mean colour (u8 range)
    xy: jnp.ndarray        # [K, 2] i32, mean pixel (x, y)
    size: jnp.ndarray      # [K] i32 (SP/DASP) — pixel count
    center: jnp.ndarray    # [K, 3] f32 — mean 3-D point (mm)
    normal: jnp.ndarray    # [K, 3] f32 — mean normal (-1 sentinel)
    variance: jnp.ndarray  # [K] f32 — normal coherence (mean dot with mean)


class SLICResult(NamedTuple):
    labels: jnp.ndarray    # [H, W] i32, cluster id or -1
    distance: jnp.ndarray  # [H, W] f32
    clusters: Clusters


def _grid_geometry(grid: GridParams, height: int, width: int):
    ws_x = width // grid.cols
    ws_y = height // grid.rows
    return ws_x, ws_y


def init_labels(grid: GridParams, height: int, width: int) -> jnp.ndarray:
    """Grid initialisation (initLD, SuperpixelSegmentation.cu:3-14)."""
    ws_x, ws_y = _grid_geometry(grid, height, width)
    v = jnp.arange(height, dtype=jnp.int32)[:, None]
    u = jnp.arange(width, dtype=jnp.int32)[None, :]
    return (v // ws_y) * grid.cols + (u // ws_x)


def _normal_valid_or(n: jnp.ndarray) -> jnp.ndarray:
    """`n.x != -1 || n.y != -1 || n.z != -1` (assignment-style validity)."""
    return jnp.any(n != INVALID_NORMAL, axis=-1)


def _normal_valid_and(n: jnp.ndarray) -> jnp.ndarray:
    """`n.x != -1 && n.y != -1 && n.z != -1` (seed-style validity)."""
    return jnp.all(n != INVALID_NORMAL, axis=-1)


# -------------------------------------------------------------- label index


class _GlobalIndex:
    """Per-pixel gathers / segment sums keyed by the full [K] cluster id
    space — one-hot products off the CPU, jnp.take/segment_sum on it."""

    def __init__(self, labels: jnp.ndarray, k: int):
        self.labels = labels
        self.k = k
        self.oh = tables.one_hot(labels, k) if tables.use_onehot() else None

    def gather(self, table: jnp.ndarray) -> jnp.ndarray:
        return tables.gather(table, self.labels, onehot=self.oh)

    def segment_sum(self, feats: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
        if self.oh is not None:
            ohm = self.oh * mask.reshape(-1, 1).astype(self.oh.dtype)
            return tables.segment_sum(feats, self.labels, self.k, onehot=ohm)
        masked = jnp.where(mask, self.labels, -1)
        return tables.segment_sum(feats, masked, self.k)

    def counts(self) -> jnp.ndarray:
        """Pixels per label [K] f32 (labels < 0 dropped)."""
        ones = jnp.ones(self.labels.shape + (1,), jnp.float32)
        return self.segment_sum(ones, self.labels >= 0)[:, 0]

    def pair_counts(self, labels_b: jnp.ndarray) -> jnp.ndarray:
        """[K, K] f32: occurrences of (own label, labels_b) pixel pairs;
        pairs with either side < 0 are dropped."""
        if self.oh is not None:
            ohb = tables.one_hot(labels_b, self.k)
            return jax.lax.dot_general(
                self.oh, ohb, dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        a = self.labels.reshape(-1)
        b = labels_b.reshape(-1)
        la = jnp.where(a >= 0, a, self.k)
        lb = jnp.where(b >= 0, b, self.k)
        m = jnp.zeros((self.k + 1, self.k + 1), jnp.float32)
        return m.at[la, lb].add(1.0)[: self.k, : self.k]


class _CellIndex:
    """Cell-local label index.  Valid ONLY when every label is either -1 or
    drawn from its pixel's cell-grid (2r)^2 neighbourhood — which holds after
    the FIRST assignment sweep (whose candidate set is exactly that).

    gather:      out = sum_n oh[r,c,p,n] * cand_table[r,c,n,:]
    segment sum: per-cell partials oh^T @ feats -> [r,c,n,F], then a tiny
                 [r*c*n, K] one-hot matmul folds candidates back to clusters.
    All products are exact (0/1 one-hots x f32 tables at HIGHEST).
    """

    def __init__(
        self,
        labels: jnp.ndarray,
        grid: GridParams,
        r: int,
        h: int,
        w: int,
    ):
        rows, cols = grid.rows, grid.cols
        self.rows, self.cols = rows, cols
        self.k = grid.num_clusters
        self.h, self.w = h, w
        self.r = r
        self.labels = labels
        self.bs_y, self.bs_x = h // rows, w // cols
        offs = [(dy, dx) for dy in range(-r, r) for dx in range(-r, r)]
        self.n = len(offs)
        self.cand = self._cand_grid(offs)           # [rows, cols, n]
        lb = self._to_cells(labels[..., None].astype(jnp.int32))[..., 0]
        self.oh = (lb[..., None] == self.cand[:, :, None, :]).astype(jnp.bfloat16)
        self.cand_flat = self.cand.reshape(-1)
        self.oh_k = (
            tables.one_hot(self.cand_flat, self.k) if tables.use_onehot() else None
        )

    def _to_cells(self, x: jnp.ndarray) -> jnp.ndarray:
        """[H, W, F] -> [rows, cols, P, F]  (P = cell pixel count)."""
        f = x.shape[-1]
        return (
            x.reshape(self.rows, self.bs_y, self.cols, self.bs_x, f)
            .transpose(0, 2, 1, 3, 4)
            .reshape(self.rows, self.cols, self.bs_y * self.bs_x, f)
        )

    def _from_cells(self, x: jnp.ndarray) -> jnp.ndarray:
        """[rows, cols, P, F] -> [H, W, F]."""
        f = x.shape[-1]
        return (
            x.reshape(self.rows, self.cols, self.bs_y, self.bs_x, f)
            .transpose(0, 2, 1, 3, 4)
            .reshape(self.h, self.w, f)
        )

    def _cand_grid(self, offs) -> jnp.ndarray:
        """[rows, cols, len(offs)] cluster ids of each cell's offset
        neighbours (-9 outside the grid)."""
        rows, cols = self.rows, self.cols
        cy = jnp.arange(rows, dtype=jnp.int32)[:, None, None]
        cx = jnp.arange(cols, dtype=jnp.int32)[None, :, None]
        dy = jnp.asarray([o[0] for o in offs], jnp.int32)[None, None, :]
        dx = jnp.asarray([o[1] for o in offs], jnp.int32)[None, None, :]
        ny, nx = cy + dy, cx + dx
        in_grid = (ny >= 0) & (ny < rows) & (nx >= 0) & (nx < cols)
        return jnp.where(in_grid, ny * cols + nx, -9)

    def _cand_table(self, table: jnp.ndarray) -> jnp.ndarray:
        """[K, F] -> [rows, cols, n, F] candidate tables (invalid rows 0)."""
        g = tables.gather(table, self.cand_flat, onehot=self.oh_k)
        return g.reshape(self.rows, self.cols, self.n, table.shape[-1])

    def gather(self, table: jnp.ndarray) -> jnp.ndarray:
        ct = self._cand_table(table)
        # f32 HIGHEST: exact for 0/1 one-hots (see tables._dot)
        out = lax.dot_general(
            self.oh.astype(jnp.float32), ct,
            dimension_numbers=(((3,), (2,)), ((0, 1), (0, 1))),
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        )
        return self._from_cells(out)

    def segment_sum(self, feats: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
        fb = self._to_cells(
            (feats * mask[..., None]).astype(jnp.float32)
        )
        # f32 HIGHEST: see gather above / tables._dot
        part = lax.dot_general(
            self.oh.astype(jnp.float32), fb,
            dimension_numbers=(((2,), (2,)), ((0, 1), (0, 1))),
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        )
        part_flat = part.reshape(-1, feats.shape[-1])
        return tables.segment_sum(
            part_flat, self.cand_flat, self.k, onehot=self.oh_k
        )

    def counts(self) -> jnp.ndarray:
        """Pixels per label [K] f32: per-cell candidate histograms (a pure
        reduction of the one-hot) folded to clusters by the tiny K one-hot."""
        per = jnp.sum(self.oh.astype(jnp.float32), axis=2)  # [rows, cols, n]
        return tables.segment_sum(
            per.reshape(-1, 1), self.cand_flat, self.k, onehot=self.oh_k
        )[:, 0]

    def pair_counts(self, labels_b: jnp.ndarray) -> jnp.ndarray:
        """[K, K] f32: POSITIVE where a (own label, labels_b) pixel pair
        exists, 0 elsewhere.  (Values are existence indicators, not exact
        pair counts: intermediates are thresholded to 0/1 so every fold is a
        single bf16 matmul — the CCL consumer only tests > 0.)

        labels_b must be a <=1-pixel shift of cell-local labels, so its values
        lie in the ENLARGED (2r+1)^2 candidate set of each pixel's cell.  The
        pair matrix is accumulated per cell in candidate coordinates
        ([nA, nB] per cell) and folded to [K, K] by the candidate one-hots —
        no [H*W, K] one-hot is ever materialised."""
        rows, cols, r = self.rows, self.cols, self.r
        offs_b = [
            (dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
        ]
        nb = len(offs_b)
        cand_b = self._cand_grid(offs_b)            # [rows, cols, nb]
        lb_b = self._to_cells(labels_b[..., None].astype(jnp.int32))[..., 0]
        oh_b = (lb_b[..., None] == cand_b[:, :, None, :]).astype(jnp.bfloat16)
        # per-cell pair existence in candidate coordinates
        m = lax.dot_general(
            self.oh, oh_b,
            dimension_numbers=(((2,), (2,)), ((0, 1), (0, 1))),
            preferred_element_type=jnp.float32,
        ).reshape(rows * cols, self.n, nb)
        m = (m > 0.0).astype(jnp.bfloat16)          # 0/1: folds stay exact bf16
        oh_bk = tables.one_hot(cand_b, self.k).reshape(rows * cols, nb, self.k)
        oh_ak = tables.one_hot(self.cand, self.k).reshape(
            rows * cols, self.n, self.k
        )
        # fold both candidate axes to cluster ids: sum_c U_a[c]^T m[c] U_b[c]
        t = lax.dot_general(
            m, oh_bk,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # [C, nA, K]; counts <= nb, exact in f32
        t = (t > 0.0).astype(jnp.bfloat16)
        return lax.dot_general(
            oh_ak, t,
            dimension_numbers=(((0, 1), (0, 1)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [K, K]; integer counts < 2^24, exact in f32


def _cell_ok(grid: GridParams, h: int, w: int) -> bool:
    return h % grid.rows == 0 and w % grid.cols == 0


def labels_within_cap(
    labels: jnp.ndarray, grid: GridParams, cap: int, h: int, w: int
) -> jnp.ndarray:
    """Scalar bool: every label >= 0 lies in its pixel's [-cap, cap-1]^2
    cell-grid neighbourhood — the capped-locality invariant that lets later
    SLIC iterations (and downstream per-cluster gathers) run the cell-space
    fast path.  Cheap (two integer maps + a reduction); used as the lax.cond
    predicate guarding the exact global fallback."""
    ws_x, ws_y = _grid_geometry(grid, h, w)
    lab0 = jnp.maximum(labels, 0)
    dyl = lab0 // grid.cols - (
        jnp.arange(h, dtype=jnp.int32) // ws_y
    )[:, None]
    dxl = lab0 % grid.cols - (
        jnp.arange(w, dtype=jnp.int32) // ws_x
    )[None, :]
    ok = (labels < 0) | (
        (dyl >= -cap) & (dyl <= cap - 1) & (dxl >= -cap) & (dxl <= cap - 1)
    )
    return jnp.all(ok)


def cell_index(
    labels: jnp.ndarray,
    grid: GridParams,
    neighborhood: int,
) -> Optional[_CellIndex]:
    """Public constructor for downstream ops (CCL) that consume single-
    iteration SLIC labels; returns None when the cell path doesn't apply."""
    h, w = labels.shape
    if not (_use_cell() and _cell_ok(grid, h, w)):
        return None
    return _CellIndex(labels, grid, neighborhood // 2, h, w)


# ----------------------------------------------------------------- seeding


def _edge_shift(padded: jnp.ndarray, dy: int, dx: int, r: int, h: int, w: int):
    """Slice view of an edge-padded array displaced by (dy, dx) — clamped
    indexing as pad+slice (no per-pixel gather)."""
    start = [r + dy, r + dx] + [0] * (padded.ndim - 2)
    sizes = [h, w] + list(padded.shape[2:])
    return lax.slice(padded, start, [s + z for s, z in zip(start, sizes)])


def _color_gradient(color_f: jnp.ndarray) -> jnp.ndarray:
    """Mean colour-distance gradient over an 11x11 clamped window
    (sampleInitialClusters, SuperpixelSegmentation.cu:39-60; bug (a) fixed:
    the comparison pixel is the clamped window neighbour)."""
    h, w, _ = color_f.shape
    cpad = jnp.pad(color_f, [(5, 5), (5, 5), (0, 0)], mode="edge")
    sum_g = jnp.zeros((h, w), jnp.float32)
    count = jnp.zeros((h, w), jnp.float32)
    for dy in range(-5, 6):
        for dx in range(-5, 6):
            nb = _edge_shift(cpad, dy, dx, 5, h, w)
            # explicit association (see _nasp_gradient)
            g = jnp.sqrt(
                (
                    jnp.square(color_f[..., 0] - nb[..., 0])
                    + jnp.square(color_f[..., 1] - nb[..., 1])
                )
                + jnp.square(color_f[..., 2] - nb[..., 2])
            )
            sum_g = sum_g + g
            count = count + (g > 0.0)
    return jnp.where(count > 0, sum_g / jnp.maximum(count, 1.0), jnp.inf)


def _nasp_gradient(color_f: jnp.ndarray, normals: jnp.ndarray) -> jnp.ndarray:
    """NASP seed gradient: colour term scaled by (1 - |n.n'|) when both
    normals are valid (AND-validity), NormalAdaptiveSuperpixel.cu:39-71."""
    h, w, _ = color_f.shape
    valid_c = _normal_valid_and(normals)
    cpad = jnp.pad(color_f, [(5, 5), (5, 5), (0, 0)], mode="edge")
    npad = jnp.pad(normals, [(5, 5), (5, 5), (0, 0)], mode="edge")
    sum_g = jnp.zeros((h, w), jnp.float32)
    count = jnp.zeros((h, w), jnp.float32)
    for dy in range(-5, 6):
        for dx in range(-5, 6):
            nb = _edge_shift(cpad, dy, dx, 5, h, w)
            # explicit association: a fixed summation order (XLA may
            # contract jnp.sum(x*y, -1) into an FMA chain)
            g = jnp.sqrt(
                (
                    jnp.square(color_f[..., 0] - nb[..., 0])
                    + jnp.square(color_f[..., 1] - nb[..., 1])
                )
                + jnp.square(color_f[..., 2] - nb[..., 2])
            )
            nnb = _edge_shift(npad, dy, dx, 5, h, w)
            both = valid_c & _normal_valid_and(nnb)
            ndiff = jnp.abs(
                (
                    normals[..., 0] * nnb[..., 0]
                    + normals[..., 1] * nnb[..., 1]
                )
                + normals[..., 2] * nnb[..., 2]
            )
            g = jnp.where(both, g * (1.0 - ndiff), g)
            sum_g = sum_g + g
            count = count + (g > 0.0)
    return jnp.where(count > 0, sum_g / jnp.maximum(count, 1.0), jnp.inf)


def _subgrid_ok(grid: GridParams, h: int, w: int, window: int) -> bool:
    """True when every seed window's gradient support stays inside its cell,
    so the gradient can be computed on the seed sub-grid alone."""
    if not _cell_ok(grid, h, w):
        return False
    ws_x, ws_y = _grid_geometry(grid, h, w)
    r = window // 2
    m = _GRAD_MARGIN
    return (
        ws_y // 2 - r - m >= 0
        and ws_y // 2 + r - 1 + m <= ws_y - 1
        and ws_x // 2 - r - m >= 0
        and ws_x // 2 + r - 1 + m <= ws_x - 1
    )


def _subgrid_extract(
    arr: jnp.ndarray, grid: GridParams, h: int, w: int, window: int
) -> jnp.ndarray:
    """Pure reshape/slice extraction of the per-cell seed bands:
    [H, W, C] -> [rows*(window+2m), cols*(window+2m), C]."""
    ws_x, ws_y = _grid_geometry(grid, h, w)
    r = window // 2
    m = _GRAD_MARGIN
    blk = window + 2 * m
    y0 = ws_y // 2 - r - m
    x0 = ws_x // 2 - r - m
    c = arr.shape[-1]
    sub = arr.reshape(grid.rows, ws_y, w, c)[:, y0 : y0 + blk]
    sub = sub.reshape(grid.rows * blk, grid.cols, ws_x, c)[:, :, x0 : x0 + blk]
    return sub.reshape(grid.rows * blk, grid.cols * blk, c)


def _sample_seeds_subgrid(
    gradient_sub: jnp.ndarray, grid: GridParams, h: int, w: int, window: int
) -> jnp.ndarray:
    """sample_seeds on the extracted sub-grid: the seed windows sit at the
    centre of each (window+2m) block; ties and ordering identical."""
    ws_x, ws_y = _grid_geometry(grid, h, w)
    r = window // 2
    m = _GRAD_MARGIN
    blk = window + 2 * m
    g_blocks = (
        gradient_sub.reshape(grid.rows, blk, grid.cols, blk)[
            :, m : m + window, :, m : m + window
        ]
        .transpose(0, 2, 1, 3)
        .reshape(grid.rows, grid.cols, window * window)
    )
    best = jnp.argmin(g_blocks, axis=-1)
    offs = jnp.arange(window, dtype=jnp.int32) - r
    off_y = offs[best // window]
    off_x = offs[best % window]
    cy = jnp.arange(grid.rows, dtype=jnp.int32)[:, None] * ws_y + ws_y // 2
    cx = jnp.arange(grid.cols, dtype=jnp.int32)[None, :] * ws_x + ws_x // 2
    seed_y = (cy + off_y).reshape(-1)
    seed_x = (cx + off_x).reshape(-1)
    return jnp.stack([seed_x, seed_y], axis=-1).astype(jnp.int32)


def sample_seeds(
    gradient: jnp.ndarray,
    grid: GridParams,
    height: int,
    width: int,
    window: int,
) -> jnp.ndarray:
    """Per cluster, the (x, y) of the minimum-gradient pixel in a
    `window x window` block around the grid centre, ties to the first pixel
    in row-major offset order (== the reference tree reduction).

    Returns seeds [K, 2] i32 (x, y).  window is the CUDA blockDim (16 for SP,
    4 for DASP, 8 for NASP); offsets run -window/2 .. window/2 - 1.
    """
    ws_x, ws_y = _grid_geometry(grid, height, width)
    r = window // 2
    shape = (grid.rows, grid.cols, window, window)
    cx = (jnp.arange(grid.cols, dtype=jnp.int32) * ws_x + ws_x // 2)
    cy = (jnp.arange(grid.rows, dtype=jnp.int32) * ws_y + ws_y // 2)
    offs = jnp.arange(window, dtype=jnp.int32) - r  # -w/2 .. w/2-1
    yy = jnp.broadcast_to(cy[:, None, None, None] + offs[None, None, :, None], shape)
    xx = jnp.broadcast_to(cx[None, :, None, None] + offs[None, None, None, :], shape)
    yy = jnp.clip(yy, 0, height - 1)
    xx = jnp.clip(xx, 0, width - 1)
    g = gradient[yy, xx].reshape(grid.rows, grid.cols, -1)
    best = jnp.argmin(g, axis=-1)[..., None]
    seed_y = jnp.take_along_axis(yy.reshape(grid.rows, grid.cols, -1), best, -1)[..., 0]
    seed_x = jnp.take_along_axis(xx.reshape(grid.rows, grid.cols, -1), best, -1)[..., 0]
    return jnp.stack([seed_x.reshape(-1), seed_y.reshape(-1)], axis=-1).astype(jnp.int32)


def _compute_seeds(
    color_f: jnp.ndarray,
    normals: Optional[jnp.ndarray],
    grid: GridParams,
    h: int,
    w: int,
    window: int,
    variant: str,
) -> jnp.ndarray:
    """Seed sampling; on the sub-grid fast path the gradient is evaluated
    only where the seed windows can read it (bit-identical by construction)."""

    def grad(cf, nm):
        if variant == "nasp":
            return _nasp_gradient(cf, nm)
        return _color_gradient(cf)

    if _subgrid_ok(grid, h, w, window):
        csub = _subgrid_extract(color_f, grid, h, w, window)
        nsub = (
            _subgrid_extract(normals, grid, h, w, window)
            if variant == "nasp"
            else None
        )
        return _sample_seeds_subgrid(grad(csub, nsub), grid, h, w, window)
    return sample_seeds(grad(color_f, normals), grid, h, w, window)


def init_clusters(
    seeds: jnp.ndarray,
    color: jnp.ndarray,
    points: Optional[jnp.ndarray],
    normals: Optional[jnp.ndarray],
) -> Clusters:
    """Seed the cluster table (store sections of sampleInitialClusters*;
    bug (b) fixed: the real blue channel is stored)."""
    k = seeds.shape[0]
    sx, sy = seeds[:, 0], seeds[:, 1]
    rgb = color[sy, sx].astype(jnp.float32)
    center = (
        points[sy, sx]
        if points is not None
        else jnp.zeros((k, 3), jnp.float32)
    )
    normal = (
        normals[sy, sx]
        if normals is not None
        else jnp.full((k, 3), INVALID_NORMAL, jnp.float32)
    )
    return Clusters(
        rgb=rgb,
        xy=seeds,
        size=jnp.zeros((k,), jnp.int32),
        center=center,
        normal=normal,
        variance=jnp.zeros((k,), jnp.float32),
    )


# -------------------------------------------------------------- assignment


def _assign(
    labels: jnp.ndarray,
    distance: jnp.ndarray,
    clusters: Clusters,
    color_f: jnp.ndarray,
    points: Optional[jnp.ndarray],
    normals: Optional[jnp.ndarray],
    grid: GridParams,
    params: SLICParams,
    variant: str,
    neighborhood: int,
    s_scale: float,
    cell_fast: bool = False,
    cell_capped: int = 0,
):
    """One label-assignment sweep (calculate_LD / calculateLD / calculateLD_NASP).

    cell_fast: labels are the grid init (first iteration) and the image
    divides evenly — candidate features broadcast per cell, zero gathers.

    cell_capped=c (later iterations): labels are cell-LOCAL within the
    pixel's [-c, c-1]^2 cell neighbourhood (caller-checked; see
    labels_within_cap + the lax.cond fallback in segment()).  The reference
    semantics — candidates are the (2r)^2 cells around the CURRENT label's
    cell — are reproduced in band space by sweeping the ENLARGED offset set
    [-c-r, c+r-2]^2 relative to the pixel's own cell and masking each
    candidate o to pixels whose label-cell offset d satisfies
    o - d in [-r, r-1]^2.  Offsets are swept in (dy, dx)-lexicographic
    order, so o - d is visited in the reference's window order per pixel and
    the strict-< running argmin keeps identical tie-breaks.  Pixels with
    label -1 (only ever pixels with invalid depth, which the post-sweep
    override re-marks -1) have no valid candidate and keep their current
    (label, distance) — identical to the reference post-override.
    """
    h, w = labels.shape
    r = neighborhood // 2
    v = jnp.arange(h, dtype=jnp.float32)[:, None]
    u = jnp.arange(w, dtype=jnp.float32)[None, :]

    # current cluster grid coords; C integer division truncates toward zero,
    # and label -1 only occurs for pixels that get re-marked -1 afterwards,
    # so clamping to 0 is behaviour-preserving.
    lab0 = jnp.maximum(labels, 0)
    cur_cx = lab0 % grid.cols
    cur_cy = lab0 // grid.cols

    if variant == "sp":
        denom = params.spatial_sigma + params.color_sigma
        w_col = params.color_sigma / denom
        w_spa = params.spatial_sigma / denom
    else:
        total = params.spatial_sigma + params.color_sigma + params.depth_sigma
        if variant == "nasp":
            total = total + params.normal_sigma
        w_col = (params.color_sigma / total) ** 2
        w_spa = (params.spatial_sigma / total) ** 2
        w_dep = (params.depth_sigma / total) ** 2
        w_nor = (params.normal_sigma / total) ** 2 if variant == "nasp" else 0.0

    z = points[..., 2] if points is not None else None
    best_d = jnp.full((h, w), jnp.inf, jnp.float32)
    best_l = jnp.full((h, w), -1, jnp.int32)

    def consider(cand_d, cand_l, best):
        bd, bl = best
        take = cand_d < bd  # strict: first occurrence wins ties (tid order)
        return jnp.where(take, cand_d, bd), jnp.where(take, cand_l, bl)

    offs = [(dy, dx) for dy in range(-r, r) for dx in range(-r, r)]
    k = grid.num_clusters
    # per-variant field layout: rgb(3) + xy(2) [+ center z(1)] [+ normal(3)]
    cols = [clusters.rgb, clusters.xy.astype(jnp.float32)]
    if variant != "sp":
        cols.append(clusters.center[:, 2:3])
    if variant == "nasp":
        cols.append(clusters.normal)
    fields = jnp.concatenate(cols, axis=-1)
    nf = fields.shape[1]

    if cell_fast or cell_capped:
        # labels == grid init (cell_fast) or cell-local within the capped
        # neighbourhood (cell_capped): a cell's pixels share the candidate
        # cluster, so the distance computation runs in band space
        # [rows, bs_y, W] (a bitcast reshape of [H, W]) with the candidate
        # features pre-expanded to [rows, 1, W] maps.  Per offset that
        # materialises only a tiny [rows, W, nf] map (~0.35 MB) instead of a
        # full [H, W, nf] one (11 MB) — for NASP's 64 offsets this cuts the
        # stage's device-memory traffic ~30x.
        rows, cls = grid.rows, grid.cols
        bs_y, bs_x = h // rows, w // cls

        def tob(x):
            return x.reshape(rows, bs_y, w)

        cfc = [tob(color_f[..., i]) for i in range(3)]
        ub = u[None, :, :]                      # [1, 1, W] iota
        vb = jnp.arange(h, dtype=jnp.float32).reshape(rows, bs_y, 1)
        zc = tob(z) if z is not None else None
        nmc = (
            [tob(normals[..., i]) for i in range(3)]
            if variant == "nasp"
            else None
        )
        dist_b = tob(distance)
        lab_b = tob(labels)
        bd = jnp.full((rows, bs_y, w), jnp.inf, jnp.float32)
        bl = jnp.full((rows, bs_y, w), -1, jnp.int32)

        if cell_capped:
            # sweep the enlarged offset set; per-pixel validity masks each
            # candidate o to o - d in [-r, r-1]^2 with d the label's cell
            # offset from the pixel's own cell
            span = cell_capped + r
            offs_band = [
                (dy, dx)
                for dy in range(-span, span - 1)
                for dx in range(-span, span - 1)
            ]
            lab0_b = jnp.maximum(lab_b, 0)
            dyl = lab0_b // grid.cols - jnp.arange(
                rows, dtype=jnp.int32
            ).reshape(rows, 1, 1)
            dxl = lab0_b % grid.cols - (
                jnp.arange(w, dtype=jnp.int32) // bs_x
            ).reshape(1, 1, w)
            lab_valid = lab_b >= 0
        else:
            span = r
            offs_band = offs

        gf = jnp.pad(
            fields.reshape(rows, cls, nf), ((span, span), (span, span), (0, 0))
        )
        cyg = jnp.arange(rows, dtype=jnp.int32)
        cxg = jnp.arange(cls, dtype=jnp.int32)

        def expand(cell_map):  # [rows, cols, F] -> [rows, 1, W, F]
            return jnp.repeat(cell_map, bs_x, axis=1)[:, None, :]

        for dy, dx in offs_band:
            cell = lax.slice(
                gf,
                (span + dy, span + dx, 0),
                (span + dy + rows, span + dx + cls, nf),
            )
            cc = expand(cell)                   # [rows, 1, W, nf]
            ing_cell = (
                ((cyg + dy >= 0) & (cyg + dy < rows))[:, None]
                & ((cxg + dx >= 0) & (cxg + dx < cls))[None, :]
            )
            rid_cell = (cyg + dy)[:, None] * grid.cols + (cxg + dx)[None, :]
            ing = expand(ing_cell[..., None])[..., 0]
            rid = expand(rid_cell[..., None])[..., 0]
            if cell_capped:
                # this offset o is one of the pixel's (2r)^2 label-window
                # offsets iff o - d in [-r, r-1]^2.  Non-window offsets are
                # NO-OPS (win=False below); window offsets whose candidate
                # cell is off-grid contribute the CURRENT (distance, label)
                # exactly like the global route's in_grid else-branch.
                win = (
                    lab_valid
                    & (dyl >= dy - (r - 1)) & (dyl <= dy + r)
                    & (dxl >= dx - (r - 1)) & (dxl <= dx + r)
                )
            else:
                win = None
            c_rgb = [cc[..., i] for i in range(3)]
            c_x, c_y = cc[..., 3], cc[..., 4]
            cd = (
                jnp.square(cfc[0] - c_rgb[0])
                + jnp.square(cfc[1] - c_rgb[1])
                + jnp.square(cfc[2] - c_rgb[2])
            )
            pd = jnp.sqrt(jnp.square(ub - c_x) + jnp.square(vb - c_y)) * (
                s_scale**2
            )
            if variant == "sp":
                dist = cd * w_col + pd * w_spa
            else:
                c_cz = cc[..., 5]
                zpair = (zc > VALID_DEPTH_MM) & (c_cz > VALID_DEPTH_MM)
                dd = jnp.where(zpair, jnp.abs(zc - c_cz), 0.0)
                dist = cd * w_col + pd * w_spa + dd * w_dep
                if variant == "nasp":
                    c_n = [cc[..., 6 + i] for i in range(3)]
                    nv_pix = (
                        (nmc[0] != INVALID_NORMAL)
                        | (nmc[1] != INVALID_NORMAL)
                        | (nmc[2] != INVALID_NORMAL)
                    )
                    nv_cand = (
                        (c_n[0] != INVALID_NORMAL)
                        | (c_n[1] != INVALID_NORMAL)
                        | (c_n[2] != INVALID_NORMAL)
                    )
                    npair = zpair & nv_pix & nv_cand
                    dot = (
                        nmc[0] * c_n[0] + nmc[1] * c_n[1] + nmc[2] * c_n[2]
                    )
                    nd = jnp.where(
                        npair, 255.0**2 * (1.0 - jnp.maximum(dot, 0.0)), 0.0
                    )
                    dist = dist + nd * w_nor
            cand_d = jnp.where(ing, dist, dist_b)
            cand_l = jnp.where(ing, rid, lab_b)
            take = cand_d < bd
            if win is not None:
                take = take & win
            bd = jnp.where(take, cand_d, bd)
            bl = jnp.where(take, cand_l, bl)

        new_labels = bl.reshape(h, w)
        new_dist = bd.reshape(h, w)
        if variant == "dasp" and params.depth_sigma != 0.0:
            invalid = z < VALID_DEPTH_MM
            new_labels = jnp.where(invalid, -1, new_labels)
            new_dist = jnp.where(invalid, 0.0, new_dist)
        if variant == "nasp" and (
            params.depth_sigma != 0.0 or params.normal_sigma != 0.0
        ):
            invalid = z < VALID_DEPTH_MM
            new_labels = jnp.where(invalid, -1, new_labels)
            new_dist = jnp.where(invalid, 0.0, new_dist)
        return new_labels, new_dist

    if tables.use_onehot():
        # bulk gather: rid == lab0 + (dy*cols + dx) for in-grid lanes, so a
        # group of offsets is ONE one-hot matmul against the horizontally
        # concatenated row-shifted tables (no per-pixel gather).  Offsets
        # are CHUNKED so the gathered
        # intermediate stays bounded (~[H, W, chunk*nf], reused across
        # chunks by the allocator) instead of one [H, W, n_off*nf] monster.
        chunk = max(1, 128 // nf)
        oh_lab0 = tables.one_hot(lab0, k)
        gathered_chunks = {}

        def shifted_table(c):
            if c >= 0:
                return jnp.pad(fields[c:], ((0, c), (0, 0)))
            return jnp.pad(fields[:c], ((-c, 0), (0, 0)))

        def gathered(i, rid, in_grid):
            ci = i // chunk
            if ci not in gathered_chunks:
                group = offs[ci * chunk : (ci + 1) * chunk]
                big = jnp.concatenate(
                    [shifted_table(dy * grid.cols + dx) for dy, dx in group],
                    axis=-1,
                )
                gathered_chunks[ci] = tables.gather(big, lab0, onehot=oh_lab0)
            j = i % chunk
            return gathered_chunks[ci][..., j * nf : (j + 1) * nf]
    else:

        def gathered(i, rid, in_grid):
            return jnp.take(fields, rid, axis=0)

    for i, (dy, dx) in enumerate(offs):
        rcx = cur_cx + dx
        rcy = cur_cy + dy
        in_grid = (rcx >= 0) & (rcx < grid.cols) & (rcy >= 0) & (rcy < grid.rows)
        rid = jnp.where(in_grid, rcy * grid.cols + rcx, 0)
        g = gathered(i, rid, in_grid)
        c_rgb = g[..., 0:3]
        c_xy = g[..., 3:5]
        cd = jnp.sum(jnp.square(color_f - c_rgb), axis=-1)
        pd = jnp.sqrt(
            jnp.square(u - c_xy[..., 0]) + jnp.square(v - c_xy[..., 1])
        ) * (s_scale**2)
        if variant == "sp":
            dist = cd * w_col + pd * w_spa
        else:
            c_cz = g[..., 5]
            zpair = (z > VALID_DEPTH_MM) & (c_cz > VALID_DEPTH_MM)
            dd = jnp.where(zpair, jnp.abs(z - c_cz), 0.0)
            dist = cd * w_col + pd * w_spa + dd * w_dep
            if variant == "nasp":
                c_n = g[..., 6:9]
                npair = (
                    zpair
                    & _normal_valid_or(normals)
                    & _normal_valid_or(c_n)
                )
                dot = jnp.sum(normals * c_n, axis=-1)
                nd = jnp.where(
                    npair, 255.0**2 * (1.0 - jnp.maximum(dot, 0.0)), 0.0
                )
                dist = dist + nd * w_nor
        cand_d = jnp.where(in_grid, dist, distance)
        cand_l = jnp.where(in_grid, rid, labels)
        best_d, best_l = consider(cand_d, cand_l, (best_d, best_l))

    new_labels, new_dist = best_l, best_d
    # invalid-depth override (DepthAdaptiveSuperpixel.cu:306-312 /
    # NormalAdaptiveSuperpixel.cu:346-352)
    if variant == "dasp" and params.depth_sigma != 0.0:
        invalid = z < VALID_DEPTH_MM
        new_labels = jnp.where(invalid, -1, new_labels)
        new_dist = jnp.where(invalid, 0.0, new_dist)
    if variant == "nasp" and (params.depth_sigma != 0.0 or params.normal_sigma != 0.0):
        invalid = z < VALID_DEPTH_MM
        new_labels = jnp.where(invalid, -1, new_labels)
        new_dist = jnp.where(invalid, 0.0, new_dist)
    return new_labels, new_dist


# ----------------------------------------------------------- cluster stats


def _window_mask(
    idx, labels: jnp.ndarray, clusters: Clusters, lo: int, hi: int,
    cxy: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Pixels within the reference's update window [lo, hi] (both dims)
    relative to their cluster's OLD mean pixel, and with a matching label.
    cxy: optionally the pre-gathered [H, W, 2] cluster-centre map (callers
    that gather more cluster fields fuse this into their own gather)."""
    h, w = labels.shape
    if cxy is None:
        cxy = idx.gather(clusters.xy.astype(jnp.float32))
    v = jnp.arange(h, dtype=jnp.float32)[:, None]
    u = jnp.arange(w, dtype=jnp.float32)[None, :]
    dx = u - cxy[..., 0]
    dy = v - cxy[..., 1]
    inside = (dx >= lo) & (dx <= hi) & (dy >= lo) & (dy <= hi)
    return inside & (labels >= 0)


def _update_sp(
    idx, labels, clusters, color_f, grid, window_range, h, w
) -> Clusters:
    """Base-SLIC cluster update (analyzeClusters, SuperpixelSegmentation.cu:297-487)."""
    lo, hi = window_range
    mask = _window_mask(idx, labels, clusters, lo, hi)
    v = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
    u = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    ones = jnp.ones((h, w), jnp.float32)
    feats = jnp.concatenate(
        [
            color_f,
            jnp.stack([u, v, ones], axis=-1),
        ],
        axis=-1,
    )
    sums = idx.segment_sum(feats, mask)
    size = sums[:, 5]
    nz = size > 0
    safe = jnp.maximum(size, 1.0)
    rgb = jnp.clip(jnp.floor(sums[:, 0:3] / safe[:, None]), 0, 255)
    xy = jnp.floor(sums[:, 3:5] / safe[:, None]).astype(jnp.int32)
    return Clusters(
        rgb=jnp.where(nz[:, None], rgb, clusters.rgb),
        xy=jnp.where(nz[:, None], xy, clusters.xy),
        size=jnp.where(nz, size.astype(jnp.int32), clusters.size),
        center=clusters.center,
        normal=clusters.normal,
        variance=clusters.variance,
    )


def _update_dasp(
    idx, labels, clusters, color_f, points, grid, window_range, h, w
) -> Clusters:
    """DASP cluster update (analyzeClusters, DepthAdaptiveSuperpixel.cu:315-568).

    3-D centre = sum of ALL labelled points / count of valid (z>50) points;
    pixel centre = 2-D centroid (reprojection branch dead, bug (c))."""
    lo, hi = window_range
    mask = _window_mask(idx, labels, clusters, lo, hi)
    v = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
    u = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    ones = jnp.ones((h, w), jnp.float32)
    validz = (points[..., 2] > VALID_DEPTH_MM).astype(jnp.float32)
    feats = jnp.concatenate(
        [
            color_f,                               # 0:3
            jnp.stack([u, v, ones], axis=-1),      # 3:6 x, y, size
            points,                                # 6:9
            validz[..., None],                     # 9 num_of_points
        ],
        axis=-1,
    )
    sums = idx.segment_sum(feats, mask)
    size = sums[:, 5]
    nz = size > 0
    safe = jnp.maximum(size, 1.0)
    rgb = jnp.clip(jnp.floor(sums[:, 0:3] / safe[:, None]), 0, 255)
    xy = jnp.floor(sums[:, 3:5] / safe[:, None]).astype(jnp.int32)
    npts = sums[:, 9]
    has_pts = npts > 0
    center = sums[:, 6:9] / jnp.maximum(npts, 1.0)[:, None]
    return Clusters(
        rgb=jnp.where(nz[:, None], rgb, clusters.rgb),
        xy=jnp.where(nz[:, None], xy, clusters.xy),
        size=jnp.where(nz, size.astype(jnp.int32), clusters.size),
        center=jnp.where((nz & has_pts)[:, None], center, clusters.center),
        normal=clusters.normal,
        variance=clusters.variance,
    )


def _update_nasp_analyze(
    idx, labels, clusters, color_f, points, normals, grid, window_range, h, w
) -> Clusters:
    """NASP plain stats (analyzeClusters_NASP, NormalAdaptiveSuperpixel.cu:356-685).

    Accepts a pixel's 3-D point / normal when z>50 and the normal is valid
    (OR-validity).  Centre = the 3-D point AT the 2-D centroid pixel when that
    pixel has valid depth, else the mean of accepted points (reprojection
    fallback dead, bug (c)).  Cluster normal = UNnormalised mean."""
    lo, hi = window_range
    mask = _window_mask(idx, labels, clusters, lo, hi)
    v = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
    u = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    ones = jnp.ones((h, w), jnp.float32)
    accept = (points[..., 2] > VALID_DEPTH_MM) & _normal_valid_or(normals)
    acc = accept.astype(jnp.float32)[..., None]
    feats = jnp.concatenate(
        [
            color_f,                           # 0:3
            jnp.stack([u, v, ones], axis=-1),  # 3:6
            points * acc,                      # 6:9
            normals * acc,                     # 9:12
            acc,                               # 12
        ],
        axis=-1,
    )
    sums = idx.segment_sum(feats, mask)
    size = sums[:, 5]
    nz = size > 0
    safe = jnp.maximum(size, 1.0)
    rgb = jnp.clip(jnp.floor(sums[:, 0:3] / safe[:, None]), 0, 255)
    xy = jnp.floor(sums[:, 3:5] / safe[:, None]).astype(jnp.int32)
    npts = sums[:, 12]
    has_pts = npts > 0

    px = jnp.clip(xy[:, 0], 0, w - 1)
    py = jnp.clip(xy[:, 1], 0, h - 1)
    pt_at_centroid = points[py, px]
    centroid_valid = pt_at_centroid[..., 2] > VALID_DEPTH_MM
    mean_pts = sums[:, 6:9] / jnp.maximum(npts, 1.0)[:, None]
    center = jnp.where(centroid_valid[:, None], pt_at_centroid, mean_pts)
    normal = sums[:, 9:12] / jnp.maximum(npts, 1.0)[:, None]

    center = jnp.where(has_pts[:, None], center, jnp.zeros_like(center))
    normal = jnp.where(
        has_pts[:, None], normal, jnp.full_like(normal, INVALID_NORMAL)
    )
    return Clusters(
        rgb=jnp.where(nz[:, None], rgb, clusters.rgb),
        xy=jnp.where(nz[:, None], xy, clusters.xy),
        size=jnp.where(nz, size.astype(jnp.int32), clusters.size),
        center=jnp.where(nz[:, None], center, clusters.center),
        normal=jnp.where(nz[:, None], normal, clusters.normal),
        variance=clusters.variance,
    )


def _update_nasp_weighted(
    idx, labels, clusters, color_f, points, normals, grid, params, window_range, h, w
) -> Clusters:
    """NASP bilateral-weighted stats (calculateWeightedAverage,
    NormalAdaptiveSuperpixel.cu:687-1068).  Runs on the analyze-updated table.

    Colour/pixel sums are weighted by exp(-dc^2/2sc^2)*exp(-dpix^2/2ss^2)
    against the cluster's mean colour / pixel centre; 3-D/normal sums accept
    pixels with z>50, valid normal, and dot(n, n_cluster) in (0.5, 1]
    (acos(clamped dot) < pi/3)."""
    lo, hi = window_range
    v = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
    u = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    g = idx.gather(
        jnp.concatenate(
            [clusters.rgb, clusters.xy.astype(jnp.float32), clusters.normal], -1
        )
    )
    c_rgb, c_xy, c_n = g[..., 0:3], g[..., 3:5], g[..., 5:8]
    mask = _window_mask(idx, labels, clusters, lo, hi, cxy=c_xy)

    cdiff = jnp.sum(jnp.square(color_f - c_rgb), axis=-1)
    cfilt = jnp.exp(-cdiff / (2.0 * params.color_sigma**2))
    sdiff = jnp.square(u - c_xy[..., 0]) + jnp.square(v - c_xy[..., 1])
    sfilt = jnp.exp(-sdiff / (2.0 * params.spatial_sigma**2))
    wgt = (cfilt * sfilt)[..., None]

    dot = jnp.sum(normals * c_n, axis=-1)
    dclamp = jnp.maximum(dot, 0.0)
    accept = (
        (points[..., 2] > VALID_DEPTH_MM)
        & _normal_valid_or(normals)
        & (dclamp > 0.5)
        & (dclamp <= 1.0)
    )
    acc = accept.astype(jnp.float32)[..., None]

    feats = jnp.concatenate(
        [
            color_f * wgt,                                  # 0:3
            jnp.stack([u, v], axis=-1) * wgt,               # 3:5
            wgt,                                            # 5 weight sum
            points * acc,                                   # 6:9
            normals * acc,                                  # 9:12
            dclamp[..., None] * acc,                        # 12 variance sum
            acc,                                            # 13 num accepted
        ],
        axis=-1,
    )
    sums = idx.segment_sum(feats, mask)
    wsum = sums[:, 5]
    nz = wsum != 0.0
    safe = jnp.where(nz, wsum, 1.0)
    rgb = jnp.clip(jnp.floor(sums[:, 0:3] / safe[:, None]), 0, 255)
    xy = jnp.floor(sums[:, 3:5] / safe[:, None]).astype(jnp.int32)
    npts = sums[:, 13]
    has_pts = npts > 0

    px = jnp.clip(xy[:, 0], 0, w - 1)
    py = jnp.clip(xy[:, 1], 0, h - 1)
    pt_at_centroid = points[py, px]
    centroid_valid = pt_at_centroid[..., 2] > VALID_DEPTH_MM
    mean_pts = sums[:, 6:9] / jnp.maximum(npts, 1.0)[:, None]
    center = jnp.where(centroid_valid[:, None], pt_at_centroid, mean_pts)

    nmean = sums[:, 9:12] / jnp.maximum(npts, 1.0)[:, None]
    nlen = jnp.sqrt(jnp.sum(jnp.square(nmean), axis=-1))
    normal = nmean / jnp.maximum(nlen, 1e-30)[:, None]
    variance = sums[:, 12] / jnp.maximum(npts, 1.0)

    center = jnp.where(has_pts[:, None], center, jnp.zeros_like(center))
    normal = jnp.where(
        has_pts[:, None], normal, jnp.full_like(normal, INVALID_NORMAL)
    )
    variance = jnp.where(has_pts, variance, 0.0)
    return Clusters(
        rgb=jnp.where(nz[:, None], rgb, clusters.rgb),
        xy=jnp.where(nz[:, None], xy, clusters.xy),
        size=jnp.where(nz, wsum.astype(jnp.int32), clusters.size),
        center=jnp.where(nz[:, None], center, clusters.center),
        normal=jnp.where(nz[:, None], normal, clusters.normal),
        variance=jnp.where(nz, variance, clusters.variance),
    )


# ------------------------------------------------------------- entry point


def segment(
    color: jnp.ndarray,
    points: Optional[jnp.ndarray] = None,
    normals: Optional[jnp.ndarray] = None,
    *,
    grid: GridParams = GridParams(),
    params: SLICParams,
    variant: str = "dasp",
    seeds: Optional[jnp.ndarray] = None,
) -> SLICResult:
    """Run a full segmentation: seed + `params.iterations` x (assign, update).

    variant: "sp" (colour SLIC, SuperpixelSegmentation::Process),
             "dasp" (DepthAdaptiveSuperpixel::Segmentation),
             "nasp" (NormalAdaptiveSuperpixel::Segmentation).
    seeds: optional [K, 2] (x, y) override of the sampled seeds — the
    gradient argmin has frequent near-ties whose winner depends on float
    precision, so tests inject oracle seeds to compare everything downstream
    deterministically.
    """
    assert variant in ("sp", "dasp", "nasp")
    h, w = color.shape[:2]
    ws_x, ws_y = _grid_geometry(grid, h, w)
    s_scale = (ws_x + ws_y) / 2.0
    color_f = color.astype(jnp.float32)

    if variant == "sp":
        seed_window, neighborhood = 16, 4
        rp = ws_x * 4 // 16 + 1
    elif variant == "dasp":
        seed_window, neighborhood = 4, 4
        rp = ws_x * 2 // 16 + 1
    else:
        seed_window, neighborhood = 8, 8
        rp = ws_x * 2 // 16 + 1
    window_range = (-8 * rp, 8 * rp - 1)

    if seeds is None:
        seeds = _compute_seeds(
            color_f, normals, grid, h, w, seed_window, variant
        )
    else:
        seeds = jnp.asarray(seeds, jnp.int32)
    clusters = init_clusters(
        seeds, color, points if variant != "sp" else None, normals
    )
    labels = init_labels(grid, h, w)
    distance = jnp.full((h, w), INIT_DISTANCE, jnp.float32)

    cell_fast = _use_cell() and _cell_ok(grid, h, w)

    def iteration(state, first: bool):
        labels, distance, clusters = state

        def update_with(idx, labels, clusters):
            if variant == "sp":
                return _update_sp(
                    idx, labels, clusters, color_f, grid, window_range, h, w
                )
            if variant == "dasp":
                return _update_dasp(
                    idx, labels, clusters, color_f, points, grid, window_range,
                    h, w,
                )
            clusters = _update_nasp_analyze(
                idx, labels, clusters, color_f, points, normals, grid,
                window_range, h, w,
            )
            return _update_nasp_weighted(
                idx, labels, clusters, color_f, points, normals, grid, params,
                window_range, h, w,
            )

        # later iterations lose the first sweep's cell-locality GUARANTEE,
        # but labels stay within a small cell neighbourhood in practice (the
        # update window pins centres near their seed cells).  The capped
        # cell route exploits that with EXACT semantics: a cheap runtime
        # check of the [-cap, cap-1]^2 invariant guards each half of the
        # iteration, falling back to the [H*W, K]-one-hot global route via
        # lax.cond only if a label ever drifts farther (locality="auto").
        # locality="cell" skips the checks (both branches are compiled under
        # cond, and a vmapped cond executes both — serving configs that
        # batch frames pick "cell"); "global" restores the old route.
        capped = (not first) and cell_fast and params.locality != "global"
        if capped:
            cap = neighborhood // 2 + 1

            def assign_cell(args):
                labels, distance, clusters = args
                return _assign(
                    labels, distance, clusters, color_f, points, normals,
                    grid, params, variant, neighborhood, s_scale,
                    cell_capped=cap,
                )

            def assign_global(args):
                labels, distance, clusters = args
                return _assign(
                    labels, distance, clusters, color_f, points, normals,
                    grid, params, variant, neighborhood, s_scale,
                )

            args = (labels, distance, clusters)
            if params.locality == "cell":
                labels, distance = assign_cell(args)
            else:
                labels, distance = lax.cond(
                    labels_within_cap(labels, grid, cap, h, w),
                    assign_cell, assign_global, args,
                )

            def upd_cell(clusters):
                idx = _CellIndex(labels, grid, cap, h, w)
                return update_with(idx, labels, clusters)

            def upd_global(clusters):
                idx = _GlobalIndex(labels, grid.num_clusters)
                return update_with(idx, labels, clusters)

            if params.locality == "cell":
                clusters = upd_cell(clusters)
            else:
                clusters = lax.cond(
                    labels_within_cap(labels, grid, cap, h, w),
                    upd_cell, upd_global, clusters,
                )
            return labels, distance, clusters

        labels, distance = _assign(
            labels, distance, clusters, color_f, points, normals,
            grid, params, variant, neighborhood, s_scale,
            cell_fast=first and cell_fast,
        )
        # one label index serves every gather/segment-sum of this iteration's
        # cluster updates; after the first sweep labels come from the cell's
        # candidate set, so the index is cell-local there
        if first and cell_fast:
            idx = _CellIndex(labels, grid, neighborhood // 2, h, w)
        else:
            idx = _GlobalIndex(labels, grid.num_clusters)
        clusters = update_with(idx, labels, clusters)
        return labels, distance, clusters

    # first iteration unrolled (it has the cell-local fast path); later
    # iterations traced once under lax.fori_loop: unrolling the reference's
    # 5-iteration pipelines explodes XLA compile time
    state = (labels, distance, clusters)
    state = iteration(state, True)
    if params.iterations > 1:
        state = jax.lax.fori_loop(
            1, params.iterations, lambda _, s: iteration(s, False), state
        )
    labels, distance, clusters = state
    return SLICResult(labels=labels, distance=distance, clusters=clusters)

"""Tile-based 3DGS rasterizer (counterpart of
``nerfstudio_tpu/ops/gsplat/rasterize.py``, ``mode="saturating"``).

1. K5, tile binning (``tile_bin``): every valid gaussian emits the packed
   key ``(tile << depth_bits | top depth bits) << id_bits | id`` for each
   slot of a fixed window around its tile (the top ``N // big_frac`` by
   radius also a wider one, minus the tiles the first already covered);
   the keys sorted, each tile's [start, count) in them. Packing the id
   under the reference's uint32 key makes the order within a tile
   deterministic (the reference's ``lax.sort`` on the key alone is not
   stable). The twin and the card's first design emit every slot, dead
   ones with the sentinel tile ``num_tiles``, sort them all and search each
   tile's first possible key; the card's default design (``"bucketed"``)
   counts the live pairs per tile, scans the counts, scatters the keys to
   their tiles and sorts each tile in shared memory, with no host sync.
2. K6, the saturating blend (``_BlendSaturating``): each 16x16 tile blends
   its full depth-sorted list front to back; a pixel stops once its
   transmittance falls below 1e-4 (gsplat's rule, which the reference
   approximates per 64-tile batch), after blending the entry that took it
   there. On the card the default design ("culled") gives each staged
   entry a box outside which no pixel blends it (``_cull_extents``), and
   each warp (8x4 pixels) walks only the entries whose box its rectangle
   meets (``_warp_culled``): bit-equal to the first design ("per_pixel"),
   which walks every entry. The backward replays back to front into a
   packed (N, 11) gradient: d means2d, d conics, d channels [rgb, depth,
   1], d opacity, summed over each tile in shared memory before one flush
   per entry.

On CUDA tensors the hand-written kernels of ``csrc/gsplat.cu`` run (in
K5's first design, which only chip_smoke.py takes, the sort between its two
kernels is ``torch.sort``); on CPU tensors the plain PyTorch twins in this
module. ``mode="bounded"`` is retired and not ported."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.ops.gsplat import _cuda

TILE = 16
_COORD_LIMIT = float(2**30)
# Elements of one (tiles, pixels, entries) intermediate in the K6 twins.
_TWIN_BATCH_ELEMENTS = 1 << 24


# K6 forward's designs on the card, by their C design codes: "culled" (the
# default), each warp walks only the staged entries whose box its
# rectangle meets; "per_pixel", every pixel walks every entry. Bit-equal;
# chip_smoke.py times both in turns.
BLEND_FWD_DESIGNS = ("culled", "per_pixel")
_BLEND_FWD_CODES = {"culled": 1, "per_pixel": 0}
# The culled design's warp rectangles: (width, height) in pixels, 8 a tile,
# warp w at columns (w % 2) * 8 and rows (w // 2) * 4 of its tile.
WARP_RECT = (8, 4)
# Margins of the culled design's box (csrc/gsplat.cu, cull_extents, which
# derives them): on sigma* = log(255 o), relative and absolute; on the
# conic's determinant, relative to a c; sigma's rounding per unit of
# (sqrt(a c) + |b|)^2 / det; on the half-extents, a scale.
_CULL_SIGMA_REL = 1e-3
_CULL_SIGMA_ABS = 1e-3
_CULL_DET = 1e-6
_CULL_KAPPA = 1e-6
_CULL_EXTENT_SCALE = 1.001

# K5's designs on the card: "bucketed" (the default), a counting sort by tile
# and a sort of each tile's keys in shared memory; "sorted", every slot's
# key, one torch.sort and a binary search per tile, which has no tile limit
# and takes every frame above the bucketed design's (``tile_bin_design``).
# chip_smoke.py times both.
TILE_BIN_DESIGNS = ("bucketed", "sorted")
# Keys that one block of the bucketed design's per-tile sort orders at once
# (a block radix sort of 256 threads x 8 keys; the CUDA entry checks it
# against its kSortKeys). A longer tile is sorted in runs of this many keys,
# which the block merges in global memory.
TILE_SORT_KEYS = 2048
# Shared memory one block may take on the H100 (227 KB, opt-in above 48 KB);
# the CUDA entry re-checks against its own copy (kMaxSharedBytes).
SHARED_BYTES_PER_BLOCK = 232_448


@dataclasses.dataclass(frozen=True)
class BinPlan:
    """The bucketed design's sizes for one call: ``pairs`` window slots (the
    length of ``packed``, ``ids`` and the scatter's key buffer), the keys
    one sorting block orders at once (``sort_keys``), the binning passes' per-block
    histogram (``hist_bytes``, 4 per tile) and the scratch the wrapper
    allocates besides the outputs (the tiles' cursors and the unsorted
    keys)."""

    pairs: int
    sort_keys: int
    hist_bytes: int
    scratch_bytes: int


def bin_plan(n: int, n_big: int, d: int, d_big: int, num_tiles: int) -> BinPlan:
    """The plan of a bucketed binning of ``n`` gaussians in a ``d`` x ``d``
    window and ``n_big`` in a ``d_big`` x ``d_big`` one over ``num_tiles``
    tiles; raises ValueError beyond the design's limits: fewer than 2^31
    window slots (int32 starts and ids) and a histogram that fits one block's
    shared memory (58,112 tiles; a 3840x2160 frame has 32,400)."""
    pairs = d * d * n + d_big * d_big * n_big
    if pairs >= 2**31:
        raise ValueError(f"the tile-bucketed binning takes fewer than 2^31 window slots, got {pairs}")
    if 4 * num_tiles > SHARED_BYTES_PER_BLOCK:
        raise ValueError(f"the tile-bucketed binning takes at most {SHARED_BYTES_PER_BLOCK // 4} tiles (a 4-byte "
                         f"histogram bin per tile in one block's shared memory), got {num_tiles}")
    return BinPlan(pairs, TILE_SORT_KEYS, 4 * num_tiles, 4 * num_tiles + 8 * pairs)


def tile_bin_design(num_tiles: int) -> str:
    """K5's design on the card for a frame of ``num_tiles`` tiles: the
    bucketed one while its histogram fits one block's shared memory (58,112
    tiles), else the sorted one."""
    return "sorted" if 4 * num_tiles > SHARED_BYTES_PER_BLOCK else "bucketed"


@dataclasses.dataclass
class TileBins:
    """K5's result: the sorted packed keys, the gaussian id of each sorted
    entry, and each tile's [start, start + count) in them.

    ``packed`` and ``ids`` have the capacity length d^2 N + d_big^2 N_big
    (every window slot); the first ``counts.sum()`` entries are the live
    pairs, sorted. After them the twin (and the card's first design) keep
    the sorted sentinel keys of the dead slots; on the card's default design
    those entries are undefined. ``starts``, ``counts`` and the live entries
    are equal in every design and the twin. K6 reads only ``ids``,
    ``starts`` and ``counts``."""

    packed: torch.Tensor  # (M,) int64, ascending over the live entries
    ids: torch.Tensor  # (M,) int32
    starts: torch.Tensor  # (tiles,) int32
    counts: torch.Tensor  # (tiles,) int32
    tiles_x: int
    tiles_y: int
    depth_bits: int
    id_bits: int

    @property
    def keys(self) -> torch.Tensor:
        """The reference's uint32 keys (tile << depth_bits | depth bits), as int64."""
        return self.packed >> self.id_bits


def key_bits(num_tiles: int) -> int:
    """Depth bits of the packed key (reference :296-299)."""
    tile_bits = max(int(np.ceil(np.log2(num_tiles + 2))), 1)
    depth_bits = 32 - tile_bits
    if depth_bits < 12:
        raise ValueError(f"image too large for packed keys: {num_tiles} tiles")
    return depth_bits


def id_bits(n: int) -> int:
    bits = max(int(n - 1).bit_length(), 1)
    if 32 + bits > 63:
        raise ValueError(f"{n} gaussians do not fit the packed sort key")
    return bits


def big_gaussians(radii: torch.Tensor, valid: torch.Tensor, big_frac: int) -> torch.Tensor:
    """Indices of the N // big_frac largest radii among the valid gaussians
    (reference :308, ``lax.top_k``): a stable descending sort, so ties come
    lower index first as XLA's TopK gives them."""
    b = max(radii.shape[0] // big_frac, 1)
    score = torch.where(valid, radii, torch.full_like(radii, -1.0))
    return torch.sort(score, descending=True, stable=True).indices[:b]


# --------------------------------------------------------------------------
# K5 twin


def _tile_coord(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(x), -_COORD_LIMIT, _COORD_LIMIT).to(torch.int64)


def _window(mx, my, r, tiles_x, tiles_y, d):
    """Bbox in tiles and window start (reference :238-250)."""
    x0t, y0t = _tile_coord((mx - r) / TILE), _tile_coord((my - r) / TILE)
    x1t, y1t = _tile_coord((mx + r) / TILE), _tile_coord((my + r) / TILE)
    cxt, cyt = _tile_coord(mx / TILE), _tile_coord(my / TILE)
    half = (d - 1) // 2
    lo_x, hi_x = torch.clamp_min(x0t, 0), torch.clamp_max(x1t, tiles_x - 1)
    lo_y, hi_y = torch.clamp_min(y0t, 0), torch.clamp_max(y1t, tiles_y - 1)
    sx = torch.minimum(torch.maximum(cxt - half, lo_x), torch.maximum(lo_x, hi_x - d + 1))
    sy = torch.minimum(torch.maximum(cyt - half, lo_y), torch.maximum(lo_y, hi_y - d + 1))
    return x0t, y0t, x1t, y1t, sx, sy


def _window_tile_ids(means2d, radii, valid, tiles_x, tiles_y, d) -> List[torch.Tensor]:
    """Per window slot, each gaussian's tile or the num_tiles sentinel
    (reference :230-263). Invalid gaussians are masked before any float
    coordinate is cast, so no cast is out of range."""
    mx = torch.where(valid, means2d[:, 0], 0.0)
    my = torch.where(valid, means2d[:, 1], 0.0)
    r = torch.where(valid, radii, 0.0)
    x0t, y0t, x1t, y1t, sx, sy = _window(mx, my, r, tiles_x, tiles_y, d)
    tiles = []
    for dy in range(d):
        for dx in range(d):
            tx, ty = sx + dx, sy + dy
            ok = (valid & (tx >= 0) & (tx < tiles_x) & (tx >= x0t) & (tx <= x1t)
                  & (ty >= 0) & (ty < tiles_y) & (ty >= y0t) & (ty <= y1t))
            tiles.append(torch.where(ok, ty * tiles_x + tx, tiles_x * tiles_y))
    return tiles


def _depth_bits_of(depths: torch.Tensor, depth_bits: int) -> torch.Tensor:
    """Top ``depth_bits`` of the positive float32 bit pattern (monotone)."""
    bits = torch.clamp_min(depths, 1e-20).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits >> (32 - depth_bits)


def _tile_keys_twin(means2d, radii, depths, valid, tiles_x, tiles_y, tiles_per_gauss, big_frac=0,
                    big_tiles_per_gauss=64) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Plain PyTorch key emission (reference ``_tile_keys_packed``, :266-350):
    (keys (M,) int64 holding the uint32 keys, gaussian ids (M,) int64,
    depth_bits), in the reference's emission order."""
    n = means2d.shape[0]
    num_tiles = tiles_x * tiles_y
    depth_bits = key_bits(num_tiles)
    d = max(int(np.sqrt(tiles_per_gauss)), 1)
    gid = torch.arange(n, device=means2d.device)
    tiles = _window_tile_ids(means2d, radii, valid, tiles_x, tiles_y, d)
    ids = [gid] * len(tiles)
    if big_frac:
        d_big = max(int(np.sqrt(big_tiles_per_gauss)), 1)
        idx = big_gaussians(radii, valid, big_frac)
        m_big, r_big, v_big = means2d[idx], radii[idx], valid[idx]
        big_ok = v_big & (r_big > (d * TILE) / 2.0)
        base = _window(*(torch.where(v_big, x, 0.0) for x in (m_big[:, 0], m_big[:, 1], r_big)), tiles_x, tiles_y, d)
        bsx, bsy = base[4], base[5]
        for t in _window_tile_ids(m_big, r_big, big_ok, tiles_x, tiles_y, d_big):
            tx, ty = t % tiles_x, t // tiles_x
            in_base = (tx >= bsx) & (tx < bsx + d) & (ty >= bsy) & (ty < bsy + d) & (t < num_tiles)
            tiles.append(torch.where(in_base, num_tiles, t))
            ids.append(idx)
    tile_all = torch.cat(tiles)
    id_all = torch.cat(ids)
    keys = (tile_all << depth_bits) | _depth_bits_of(depths, depth_bits)[id_all]
    return keys, id_all, depth_bits


def _tile_bin_twin(means2d, radii, depths, valid, tiles_x, tiles_y, tiles_per_gauss, big_frac,
                   big_tiles_per_gauss) -> TileBins:
    keys, ids, depth_bits = _tile_keys_twin(means2d, radii, depths, valid, tiles_x, tiles_y, tiles_per_gauss,
                                            big_frac, big_tiles_per_gauss)
    ib = id_bits(means2d.shape[0])
    packed = torch.sort((keys << ib) | ids).values
    bounds = torch.searchsorted(
        packed, torch.arange(tiles_x * tiles_y + 1, device=packed.device) << (depth_bits + ib))
    return TileBins(packed, (packed & ((1 << ib) - 1)).to(torch.int32), bounds[:-1].to(torch.int32),
                    (bounds[1:] - bounds[:-1]).to(torch.int32), tiles_x, tiles_y, depth_bits, ib)


def _tile_bin_kernel(means2d, radii, depths, valid, tiles_x, tiles_y, tiles_per_gauss, big_frac,
                     big_tiles_per_gauss, _design: Optional[str] = None) -> TileBins:
    """Launch K5 in the design ``tile_bin_design`` picks for the frame, or in
    ``_design`` (one of ``TILE_BIN_DESIGNS``), which only chip_smoke.py's
    comparison sets."""
    if _design is None:
        _design = tile_bin_design(tiles_x * tiles_y)
    if _design not in TILE_BIN_DESIGNS:
        raise ValueError(f"design {_design!r} is not one of {TILE_BIN_DESIGNS}")
    _cuda.check_cuda("tile_bin", means2d, radii, depths, valid)
    n = means2d.shape[0]
    num_tiles = tiles_x * tiles_y
    depth_bits, ib = key_bits(num_tiles), id_bits(n)
    d = max(int(np.sqrt(tiles_per_gauss)), 1)
    d_big = max(int(np.sqrt(big_tiles_per_gauss)), 1)
    idx_big = big_gaussians(radii, valid, big_frac) if big_frac else None
    n_big = 0 if idx_big is None else idx_big.shape[0]
    dev = means2d.device
    emission = (means2d.data_ptr(), radii.data_ptr(), depths.data_ptr(), valid.data_ptr(), n,
                None if idx_big is None else idx_big.data_ptr(), n_big, tiles_x, tiles_y, d, d_big, depth_bits, ib)
    i32 = dict(dtype=torch.int32, device=dev)
    starts, counts = torch.empty((num_tiles,), **i32), torch.empty((num_tiles,), **i32)
    if _design == "sorted":
        packed = torch.empty((d * d * n + d_big * d_big * n_big,), dtype=torch.int64, device=dev)
        _cuda.launch(None, "nst_gsplat_tile_keys", dev, *emission, packed.data_ptr())
        packed = torch.sort(packed).values
        ids = torch.empty(packed.shape, **i32)
        _cuda.launch("tile_bin_sorted", "nst_gsplat_tile_ranges", dev, packed.data_ptr(), packed.shape[0], tiles_x,
                     tiles_y, depth_bits, ib, ids.data_ptr(), starts.data_ptr(), counts.data_ptr())
    else:
        plan = bin_plan(n, n_big, d, d_big, num_tiles)
        packed, keys = (torch.empty((plan.pairs,), dtype=torch.int64, device=dev) for _ in range(2))
        ids, cursor = torch.empty((plan.pairs,), **i32), torch.empty((num_tiles,), **i32)
        _cuda.launch("tile_bin_bucketed", "nst_gsplat_tile_bin", dev, *emission, plan.sort_keys, counts.data_ptr(),
                     starts.data_ptr(), cursor.data_ptr(), keys.data_ptr(), packed.data_ptr(), ids.data_ptr())
    _cuda.launch_counts["tile_bin"] += 1
    return TileBins(packed, ids, starts, counts, tiles_x, tiles_y, depth_bits, ib)


def tile_bin(means2d, radii, depths, valid, width, height, tiles_per_gauss=16, big_frac=0,
             big_tiles_per_gauss=64) -> TileBins:
    """K5 (reference :398-417). means2d (N, 2), radii, depths (N,) float32 and
    valid (N,) bool, all without gradient."""
    tiles_x, tiles_y = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    args = (means2d.detach().contiguous(), radii.detach().contiguous(), depths.detach().contiguous(),
            valid.contiguous(), tiles_x, tiles_y, tiles_per_gauss, big_frac, big_tiles_per_gauss)
    if means2d.device.type == "cuda":
        return _tile_bin_kernel(*args)
    return _tile_bin_twin(*args)


# --------------------------------------------------------------------------
# K6 twin


def _tile_batches(counts: np.ndarray):
    """Consecutive tile ranges whose padded (tiles, 256, max count) block
    stays under the twins' element budget."""
    t0, n = 0, counts.shape[0]
    while t0 < n:
        t1, k = t0 + 1, max(int(counts[t0]), 1)
        while t1 < n and (t1 + 1 - t0) * 256 * max(k, int(counts[t1])) <= _TWIN_BATCH_ELEMENTS:
            k = max(k, int(counts[t1]))
            t1 += 1
        yield t0, t1, k
        t0 = t1


def _pixel_centers(tiles: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """(C,) tile indices -> (C, 256, 2) pixel centres (x, y), x fastest."""
    ar = torch.arange(TILE, dtype=torch.float32, device=tiles.device) + 0.5
    local = torch.stack([ar.repeat(TILE), ar.repeat_interleave(TILE)], dim=-1)
    origin = torch.stack([(tiles % tiles_x), (tiles // tiles_x)], dim=-1).to(torch.float32) * TILE
    return local[None] + origin[:, None, :]


def _cull_extents(means2d: torch.Tensor, conics: torch.Tensor, opac: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The culled design's box per gaussian, op for op as the kernel's
    ``cull_extents`` computes it: half-extents (ex, ey) around the mean
    outside which no pixel blends the gaussian (sigma >= 0 and alpha >
    1/255 fail). NaN: no box, never culled (a non-finite input, a conic not
    positive definite after the margin on its determinant, or a conic so
    thin that sigma's rounding bound exceeds half of it); -inf: an empty
    box, always culled (opacity <= 1/255)."""
    mx, my = means2d[:, 0], means2d[:, 1]
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    finite = torch.stack([mx, my, a, b, c, opac]).abs().lt(float("inf")).all(dim=0)
    ac = a * c
    det_lo = (ac - b * b) - _CULL_DET * ac
    s0 = torch.log(opac * 255.0)
    s0 = (s0 + _CULL_SIGMA_REL * s0.abs()) + _CULL_SIGMA_ABS
    amp = torch.sqrt(ac) + b.abs()
    kappa = _CULL_KAPPA * (amp * amp / det_lo)
    s = s0 / (1.0 - kappa)
    pd = finite & (a > 0) & (c > 0) & (det_lo > 0)
    empty = pd & ~(opac > 1.0 / 255.0)
    boxed = pd & ~empty & (kappa < 0.5)
    out = []
    for q in (c, a):
        e = torch.sqrt(2.0 * s * q / det_lo) * _CULL_EXTENT_SCALE
        out.append(torch.where(boxed, e, torch.where(empty, -float("inf"), float("nan"))))
    return out[0], out[1]


def warp_pixels(device=None) -> torch.Tensor:
    """(8, 32) int64: the tile pixels (y * 16 + x) of each warp of the culled
    design, in lane order."""
    w, h = WARP_RECT
    warp, lane = torch.arange(8, device=device)[:, None], torch.arange(32, device=device)[None, :]
    col0, row0 = (warp % (TILE // w)) * w, (warp // (TILE // w)) * h
    return (row0 + lane // w) * TILE + col0 + lane % w


def _warp_culled(means2d, ext: Tuple[torch.Tensor, torch.Tensor], gids: torch.Tensor, tiles: torch.Tensor,
                 tiles_x: int) -> torch.Tensor:
    """(C, 8, K) bool: whether warp w of tile ``tiles[c]`` (``warp_pixels``)
    skips entry ``gids[c, k]``, whose box ``ext`` (``_cull_extents``) its
    rectangle of pixel centres misses. The rectangle's extreme differences
    are computed as the kernel computes every pixel's."""
    w, h = WARP_RECT
    ex, ey = ext[0][gids][:, None, :], ext[1][gids][:, None, :]
    mx, my = means2d[gids, 0][:, None, :], means2d[gids, 1][:, None, :]
    warp = torch.arange(8, device=gids.device)
    col0 = ((warp % (TILE // w)) * w).to(torch.float32)[None, :, None]
    row0 = ((warp // (TILE // w)) * h).to(torch.float32)[None, :, None]
    ox = ((tiles % tiles_x) * TILE).to(torch.float32)[:, None, None]
    oy = ((tiles // tiles_x) * TILE).to(torch.float32)[:, None, None]
    return (((col0 + 0.5) + ox) - mx >= ex) | (((col0 + (w - 1 + 0.5)) + ox) - mx <= -ex) | \
        (((row0 + 0.5) + oy) - my >= ey) | (((row0 + (h - 1 + 0.5)) + oy) - my <= -ey)


def _blend_tiles(means2d, conics, ch, opac, bins: TileBins, t0: int, t1: int, k: int, live: int,
                 culled: bool = False) -> torch.Tensor:
    """Plain PyTorch K6 on tiles [t0, t1) padded to k entries: (C, 256, 5),
    differentiable in the four arrays. Reads only the ``live`` first entries
    of ``bins.ids`` (``TileBins``: the rest may be undefined); a padding
    entry takes the last live one's gaussian and is masked out. ``culled``:
    each warp's culled entries (``_warp_culled``) are dropped as well, as
    the culled design drops them."""
    dev = means2d.device
    tiles = torch.arange(t0, t1, device=dev)
    off = torch.arange(k, device=dev)
    in_seg = off[None, :] < bins.counts[t0:t1, None]
    entry = torch.clamp_max(bins.starts[t0:t1, None].long() + off[None, :], max(live - 1, 0))
    gids = bins.ids[entry].long() if live else torch.zeros_like(entry)
    pix = _pixel_centers(tiles, bins.tiles_x)
    # _alpha_from_gathered (reference :47-63)
    d = pix[:, :, None, :] - means2d[gids][:, None, :, :]
    con = conics[gids]
    a, b, c = con[..., 0][:, None, :], con[..., 1][:, None, :], con[..., 2][:, None, :]
    sigma = 0.5 * (a * (d[..., 0] * d[..., 0]) + c * (d[..., 1] * d[..., 1])) + b * d[..., 0] * d[..., 1]
    alpha = torch.minimum(opac[gids][:, None, :] * torch.exp(-sigma), sigma.new_tensor(0.999))
    keep = (sigma >= 0) & in_seg[:, None, :] & (alpha > 1.0 / 255.0)
    if culled:
        with torch.no_grad():
            ext = _cull_extents(means2d, conics, opac)
            skip = _warp_culled(means2d, ext, gids, tiles, bins.tiles_x)
        warp_of_pixel = torch.empty(TILE * TILE, dtype=torch.int64, device=dev)
        warp_of_pixel[warp_pixels(dev)] = torch.arange(8, device=dev)[:, None]
        keep = keep & ~skip[:, warp_of_pixel, :]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    # front to back; a pixel blends an entry while its transmittance in
    # front of it is at least 1e-4
    trans = torch.cumprod(1.0 - alpha, dim=-1)
    t_front = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    w = alpha * t_front * (t_front.detach() >= 1e-4)
    return torch.bmm(w, ch[gids])


def _tiles_to_image(t: torch.Tensor, bins: TileBins, width: int, height: int) -> torch.Tensor:
    """(tiles, 256, C) -> (height, width, C)."""
    img = t.view(bins.tiles_y, bins.tiles_x, TILE, TILE, -1).permute(0, 2, 1, 3, 4)
    return img.reshape(bins.tiles_y * TILE, bins.tiles_x * TILE, -1)[:height, :width]


def _image_to_tiles(img: torch.Tensor, bins: TileBins) -> torch.Tensor:
    """(height, width, C) -> (tiles, 256, C), zero outside the image."""
    h, w, c = img.shape
    full = img.new_zeros((bins.tiles_y * TILE, bins.tiles_x * TILE, c))
    full[:h, :w] = img
    return full.view(bins.tiles_y, TILE, bins.tiles_x, TILE, c).permute(0, 2, 1, 3, 4).reshape(-1, TILE * TILE, c)


def _blend_twin(means2d, conics, ch, opac, bins: TileBins, width: int, height: int,
                culled: bool = False) -> torch.Tensor:
    """Plain PyTorch K6 forward: (height, width, 5); ``culled``: with each
    warp's culled entries dropped (``_blend_tiles``), which must change
    nothing."""
    out = means2d.new_zeros((bins.tiles_x * bins.tiles_y, TILE * TILE, 5))
    counts = bins.counts.cpu().numpy()
    for t0, t1, k in _tile_batches(counts):
        out[t0:t1] = _blend_tiles(means2d, conics, ch, opac, bins, t0, t1, k, int(counts.sum()), culled)
    return _tiles_to_image(out, bins, width, height)


def _blend_twin_bwd(means2d, conics, ch, opac, bins: TileBins, g_ch: torch.Tensor):
    """Plain PyTorch K6 backward (autograd through the twin, one tile batch
    at a time): (d means2d, d conics, d ch, d opac)."""
    g_tiles = _image_to_tiles(g_ch, bins)
    grads = [torch.zeros_like(x) for x in (means2d, conics, ch, opac)]
    counts = bins.counts.cpu().numpy()
    for t0, t1, k in _tile_batches(counts):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (means2d, conics, ch, opac)]
            out = _blend_tiles(*leaves, bins, t0, t1, k, int(counts.sum()))
            for acc, g in zip(grads, torch.autograd.grad(out, leaves, g_tiles[t0:t1], allow_unused=True)):
                if g is not None:
                    acc += g
    return tuple(grads)


def _blend_kernel(means2d, conics, ch, opac, bins: TileBins, width: int, height: int, _design: str = "culled"):
    """Launch K6 forward in the culled design, or in ``_design`` (one of
    ``BLEND_FWD_DESIGNS``), which only chip_smoke.py's comparison sets:
    (channels (H, W, 5), final T (H, W), last entry (H, W))."""
    if _design not in BLEND_FWD_DESIGNS:
        raise ValueError(f"design {_design!r} is not one of {BLEND_FWD_DESIGNS}")
    _cuda.check_cuda("blend_saturating", means2d, conics, ch, opac, bins.ids, bins.starts, bins.counts)
    out = means2d.new_empty((height, width, 5))
    T = means2d.new_empty((height, width))
    last = torch.empty((height, width), dtype=torch.int32, device=means2d.device)
    _cuda.launch("blend_saturating", "nst_gsplat_blend_fwd", means2d.device, means2d.data_ptr(),
                 conics.data_ptr(), opac.data_ptr(), ch.data_ptr(), bins.ids.data_ptr(), bins.starts.data_ptr(),
                 bins.counts.data_ptr(), bins.tiles_x, bins.tiles_y, width, height, _BLEND_FWD_CODES[_design],
                 out.data_ptr(), T.data_ptr(), last.data_ptr())
    if _design == "per_pixel":
        _cuda.launch_counts["blend_saturating_per_pixel"] += 1
    return out, T, last


def _blend_bwd_kernel(means2d, conics, ch, opac, bins: TileBins, T, last, g_ch):
    """Launch K6 backward: (d means2d, d conics, d ch, d opac)."""
    g_ch = g_ch.contiguous()
    _cuda.check_cuda("blend_saturating backward", means2d, conics, ch, opac, T, last, g_ch)
    height, width = T.shape
    grads = means2d.new_zeros((means2d.shape[0], 11))
    _cuda.launch("blend_saturating_bwd", "nst_gsplat_blend_bwd", means2d.device, means2d.data_ptr(),
                 conics.data_ptr(), opac.data_ptr(), ch.data_ptr(), bins.ids.data_ptr(), bins.starts.data_ptr(),
                 bins.counts.data_ptr(), bins.tiles_x, bins.tiles_y, width, height, T.data_ptr(),
                 last.data_ptr(), g_ch.data_ptr(), grads.data_ptr())
    return grads[:, 0:2], grads[:, 2:5], grads[:, 5:10], grads[:, 10]


class _BlendSaturating(torch.autograd.Function):
    """K6 forward and backward; the twins on CPU tensors. The backward is
    once differentiable (the kernel's gradients carry no graph)."""

    @staticmethod
    def forward(ctx, means2d, conics, ch, opac, bins, width, height):
        ctx.bins = bins
        if means2d.device.type == "cuda":
            out, T, last = _blend_kernel(means2d, conics, ch, opac, bins, width, height)
            ctx.save_for_backward(means2d, conics, ch, opac, T, last)
        else:
            out = _blend_twin(means2d, conics, ch, opac, bins, width, height)
            ctx.save_for_backward(means2d, conics, ch, opac)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_ch):
        if g_ch.device.type == "cuda":
            means2d, conics, ch, opac, T, last = ctx.saved_tensors
            grads = _blend_bwd_kernel(means2d, conics, ch, opac, ctx.bins, T, last, g_ch)
        else:
            grads = _blend_twin_bwd(*ctx.saved_tensors, ctx.bins, g_ch)
        return (*grads, None, None, None)


def blend_saturating(means2d, conics, ch, opac, bins: TileBins, width: int, height: int) -> torch.Tensor:
    """K6: blend the binned tiles. means2d (N, 2), conics (N, 3), ch (N, 5),
    opac (N,) float32 -> (height, width, 5)."""
    return _BlendSaturating.apply(means2d.contiguous(), conics.contiguous(), ch.contiguous(), opac.contiguous(),
                                  bins, width, height)


def rasterize(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    valid: torch.Tensor,
    *,
    width: int,
    height: int,
    tiles_per_gauss: int = 16,
    mode: str = "saturating",
    big_frac: int = 0,
    big_tiles_per_gauss: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (rgb (H, W, 3), alpha (H, W, 1), depth (H, W, 1)) (reference
    :367-471, ``mode="saturating"``). The reference's batching knobs
    (``tile_chunk``, ``blend_chunk_size``, ``max_per_tile``) shape its TPU
    loops only and have no counterpart here."""
    if mode != "saturating":
        raise NotImplementedError(f"rasterize mode {mode!r}: only 'saturating' is ported ('bounded' is retired)")
    bins = tile_bin(means2d, radii, depths, valid, width, height, tiles_per_gauss, big_frac, big_tiles_per_gauss)
    ones = torch.ones_like(depths)[:, None]
    ch5 = torch.cat([colors, depths[:, None], ones], dim=-1).to(torch.float32)
    img = blend_saturating(means2d, conics, ch5, opacities.to(torch.float32), bins, width, height)
    acc = img[..., 4:5]
    return img[..., :3], acc, img[..., 3:4] / torch.clamp_min(acc, 1e-10)

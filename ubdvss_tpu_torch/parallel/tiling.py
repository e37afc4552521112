"""Row-tiled inference over a mesh: halo exchange, per-tile trunk, seam-merged
connected components.

Counterpart of ``ubdvss_tpu/parallel/tiling.py``: a large scan (BASELINE
config 4: 2048x2048 documents) is split row-wise over a
``Mesh('spatial')``.  For each entry:

  1. halo exchange — the tile takes ``halo`` rows from the tiles above and
     below it (copies to its device, ``.to(device)``, JAX's ``ppermute``;
     a tile thinner than the halo takes them from several neighbours,
     ``n_hops``; past the image edges zeros arrive);
  2. the trunk on the padded tile: ``BarcodeFCN`` with a boundary mask
     (``models/model.py``) that re-zeroes the rows outside the image after
     every layer, so the cropped logits equal the whole image's.  This is
     the module, not the context kernel (K4), which takes no mask;
  3. distributed CCL over *global* linear indices: each tile's
     ``_propagation_round`` (``ops/ccl.py``) to its fixpoint, then a seam
     exchange of boundary label rows, until a seam round changes nothing
     on any tile (JAX's ``psum`` of the flags: an ``any`` read on the host
     once a round) or ``To·n + 4n + 8`` rounds have run; the flag is
     returned, never dropped;
  4. labels and logits gathered on the first entry (``torch.cat``, JAX's
     ``all_gather``) and the XLA tail (``ops/postproc.py``):
     ``roots_from_raw_labels`` -> ``eq_from_raw_labels`` ->
     ``finish_from_eq``, identical to postprocessing the whole image.

One process drives every entry in turn; entries may repeat a device
(``parallel/mesh.py``).
"""

from __future__ import annotations

import torch

from ubdvss_tpu_torch.models.model import get_model
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.ops.ccl import _propagation_round, compact_labels
from ubdvss_tpu_torch.ops.postproc import eq_from_raw_labels, finish_from_eq, roots_from_raw_labels
from ubdvss_tpu_torch.ops.preproc import normalize, rgb_to_grayscale
from ubdvss_tpu_torch.ops.strips import receptive_field_halo

__all__ = ["distributed_connected_components", "receptive_field_halo", "tiled_detect"]


def _seam_min(nb_row, my_row_mask, sentinel, connectivity):
    """The neighbour tile's boundary row as seen by this tile's row: the
    pixel above/below it, and for 8-connectivity its two diagonals."""
    m = nb_row
    if connectivity == 8:
        big = torch.full((1,), sentinel, dtype=nb_row.dtype, device=nb_row.device)
        m = torch.minimum(m, torch.cat([nb_row[1:], big]))
        m = torch.minimum(m, torch.cat([big, nb_row[:-1]]))
    return torch.where(my_row_mask, m, sentinel)


def _local_ccl_to_fixpoint(lab, mask, sentinel, connectivity, max_iters):
    """Min-label propagation within a tile (labels carry global indices),
    the rounds of ``ops/ccl.py``, until one changes nothing or max_iters."""
    for _ in range(max_iters):
        new = _propagation_round(lab, mask, sentinel, connectivity)
        if torch.equal(new, lab):
            break
        lab = new
    return lab


def _seam_merge_ccl(labs, masks, n, sentinel, connectivity, To, Wo):
    """Distributed CCL core over the n tiles' (To, Wo) labels and masks
    (each on its entry's device): local fixpoints, then a seam exchange,
    until a seam round changes nothing anywhere or ``To·n + 4n + 8``
    rounds.  Returns ``(labs, converged, rounds)``: converged is False only
    when the cap ended the loop."""
    max_rounds = To * n + 4 * n + 8
    changing, rounds = True, 0
    while changing and rounds < max_rounds:
        labs = [_local_ccl_to_fixpoint(lab, m, sentinel, connectivity, To + Wo) for lab, m in zip(labs, masks)]
        # every tile's boundary rows after this round's fixpoint, before any update
        top_nb = [None] + [labs[i - 1][-1].to(labs[i].device) for i in range(1, n)]
        bot_nb = [labs[i + 1][0].to(labs[i].device) for i in range(n - 1)] + [None]
        new_labs, changed = [], []
        for lab, mask, top, bot in zip(labs, masks, top_nb, bot_nb):
            new_top = lab[0] if top is None else torch.minimum(lab[0], _seam_min(top, mask[0], sentinel, connectivity))
            new_bot = lab[-1] if bot is None else torch.minimum(lab[-1], _seam_min(bot, mask[-1], sentinel, connectivity))
            changed.append(torch.any(new_top != lab[0]) | torch.any(new_bot != lab[-1]))
            lab = lab.clone()
            if To == 1:
                # one heatmap row a tile: row 0 is row To-1, so both seam
                # updates merge instead of the bottom's clobbering the top's
                lab[0] = torch.minimum(new_top, new_bot)
            else:
                lab[0] = new_top
                lab[To - 1] = new_bot
            new_labs.append(lab)
        labs = new_labs
        changing = bool(torch.stack([c.to(labs[0].device) for c in changed]).any())
        rounds += 1
    return labs, not changing, rounds


def _tile_labels(masks, To, Wo, sentinel):
    """Each tile's initial labels: its pixels' global linear indices."""
    out = []
    for i, m in enumerate(masks):
        lin = i * To * Wo + torch.arange(To * Wo, dtype=torch.int32, device=m.device).reshape(To, Wo)
        out.append(torch.where(m, lin, sentinel))
    return out


def distributed_connected_components(
    mask: torch.Tensor, mesh, axis: str = "spatial", connectivity: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-tiled CCL of an (H, W) mask over the mesh's ``axis``, H divisible
    by its size.  Returns ``(labels, converged)``: the compacted labels
    (``ops/ccl.connected_components``'s, gathered on the first entry) and a
    0-d bool tensor, False when the seam loop hit its cap."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    devs = mesh.axis_devices(axis)
    n = len(devs)
    Ho, Wo = mask.shape
    if Ho % n:
        raise ValueError(f"{Ho} rows not divisible by the {n}-entry '{axis}' axis")
    To = Ho // n
    sentinel = Ho * Wo
    masks = [mask[i * To:(i + 1) * To].to(device=d, dtype=torch.bool) for i, d in enumerate(devs)]
    labs, converged, _ = _seam_merge_ccl(
        _tile_labels(masks, To, Wo, sentinel), masks, n, sentinel, connectivity, To, Wo)
    lab_full = torch.cat([lab.to(devs[0]) for lab in labs])
    labels, _ = compact_labels(lab_full, lab_full < sentinel, sentinel)
    return labels, torch.tensor(converged, device=devs[0])


def _halo_plan(H: int, n: int, cfg: NetConfig, halo: int | None) -> tuple[int, int, int]:
    """(T, halo, n_hops): rows a tile, the halo clamped to the image and
    rounded down to the scale, and the neighbours it spans."""
    if H % (n * cfg.scale):
        raise ValueError(f"H={H} not divisible by {n} tiles * scale {cfg.scale}")
    T = H // n
    if halo is None:
        halo = receptive_field_halo(cfg)
    halo = min(halo, (n - 1) * T)
    halo -= halo % cfg.scale
    return T, halo, (-(-halo // T) if halo else 0)


def _tile_logits(params: dict, image: torch.Tensor, cfg: NetConfig, devs: list, halo: int | None) -> list:
    """Steps 1-2: each tile's halo-padded rows through the masked trunk,
    cropped to its (To, Wo, C) logits, on its entry's device."""
    n = len(devs)
    H, W = image.shape[0], image.shape[1]
    T, halo, n_hops = _halo_plan(H, n, cfg, halo)
    ho, To = halo // cfg.scale, T // cfg.scale
    tiles = []
    for i, d in enumerate(devs):
        x = image[i * T:(i + 1) * T].to(device=d, dtype=torch.float32)
        tiles.append(rgb_to_grayscale(x, "rgb") if x.ndim == 3 else x)
    models = {}
    out = []
    for i, d in enumerate(devs):
        x = tiles[i]
        if n_hops:
            def hop(j):
                return tiles[j].to(d) if 0 <= j < n else torch.zeros_like(x)

            from_above = torch.cat([hop(i - h) for h in range(n_hops, 0, -1)])[n_hops * T - halo:]
            from_below = torch.cat([hop(i + h) for h in range(1, n_hops + 1)])[:halo]
            x = torch.cat([from_above, x, from_below])
        if d not in models:
            models[d] = get_model(cfg).to(d)
            models[d].load_state_dict(params)
        g_rows = i * T + torch.arange(T + 2 * halo, device=d) - halo
        row_ok = ((g_rows >= 0) & (g_rows < H)).to(torch.float32)
        bmask = row_ok[None, :, None, None].expand(1, T + 2 * halo, W, 1)
        logits = models[d](normalize(x)[None, ..., None], boundary_mask=bmask)[0]
        out.append(logits[ho:ho + To])
    return out


def tiled_detect(
    params: dict,
    image,
    cfg: NetConfig,
    mesh,
    axis: str = "spatial",
    connectivity: int = 8,
    halo: int | None = None,
) -> dict:
    """Whole-scan detection, row-tiled over the mesh's ``axis``.

    ``image``: (H, W) raw [0, 255] grayscale or (H, W, 3) RGB, H divisible
    by the axis size times ``cfg.scale``; no resize.  ``params``: the
    port's state_dict.  Returns the ``postprocess`` dict of the whole
    image plus ``logits`` (Ho, Wo, C) and ``ccl_converged`` (0-d bool), on
    the first entry's device.
    """
    devs = mesh.axis_devices(axis)
    n = len(devs)
    image = torch.as_tensor(image)
    H, W = image.shape[0], image.shape[1]
    Ho, Wo = H // cfg.scale, W // cfg.scale
    To = Ho // n
    sentinel = Ho * Wo
    with torch.inference_mode():
        tile_logits = _tile_logits(params, image, cfg, devs, halo)
        masks = [torch.sigmoid(lg[..., 0]) > cfg.detection_threshold for lg in tile_logits]
        labs, converged, _ = _seam_merge_ccl(
            _tile_labels(masks, To, Wo, sentinel), masks, n, sentinel, connectivity, To, Wo)
        lab_full = torch.cat([lab.to(devs[0]) for lab in labs])
        logits_full = torch.cat([lg.to(devs[0]) for lg in tile_logits])
        rootvals, root_valid = roots_from_raw_labels(lab_full, cfg.max_components)
        eq = eq_from_raw_labels(lab_full, rootvals, root_valid)
        idx_full = torch.arange(Ho * Wo, dtype=torch.int32, device=devs[0]).reshape(Ho, Wo)
        total = ((lab_full == idx_full) & (lab_full < sentinel)).sum().to(torch.int32)
        out = finish_from_eq(logits_full, eq, cfg, num_components_total=total)
    out["logits"] = logits_full
    out["ccl_converged"] = torch.tensor(converged, device=devs[0])
    return out

"""Work model of the warp-tile pair loop (openmm_drudenose_tpu_torch/csrc/
pair_tile.cuh) on the 100k-atom bench snapshot, on the CPU with numpy.

    python3 -m openmm_drudenose_tpu_torch.tools.walk_model

Prints the cell occupancy (mean, standard deviation, largest, share of
cells above 32 atoms) and, over every (home cell, 32-slot part, stencil
offset, 32-slot neighbour tile):

  * the diagonal walk's warp-steps, max(home atoms, tile slots) each,
    against the useful pair count over 32;
  * the cost of the walk that pair_tile::tile_pair picks (the broadcast
    walk over a remainder of at most 8 atoms where the other side has at
    least 4 more; the self offset by broadcast over the tile), relative to
    the diagonal walk alone, with a broadcast step counted as BCAST_STEP
    diagonal steps and the pass over its partial sums as BCAST_SUM (both
    estimates of instruction counts, not measurements, so this ratio is
    a model estimate);
  * the share of that cost in tiles whose atoms' bounding boxes lie
    beyond the cutoff (pair_tile::beyond: skipped by both kernels).

The counts are of the algorithm, not times; the kernels' times come from
chip_smoke.py on the card.
"""

from pathlib import Path

import numpy as np

from ..forces import cellpair
from ..io import builders

SNAPSHOT = (Path(__file__).resolve().parents[2] / "data"
            / "bench_equil_100k.npz")

BCAST_MAX = 8       # pair_tile::kBcastMax
BCAST_STEP = 1.1    # a broadcast step: a pair and 3 shared stores
BCAST_SUM = 2.0     # the pass over the partial sums: ~200 issue slots


def main():
    snap = np.load(SNAPSHOT)
    pos = np.asarray(snap["positions"], np.float64)
    n = int(snap["n_atoms"])
    system, _ = builders.build_water_box(n // 5)
    box = np.diagonal(np.array(system.getDefaultPeriodicBoxVectors()))
    cfg = cellpair.make_config(1.0, box, n, [0], [4], capacity=48)
    grid = np.array(cfg.grid)
    h = box / grid
    frac = pos / box - np.floor(pos / box)
    c3 = np.minimum((frac * grid).astype(np.int64), grid - 1)
    flat = (c3[:, 0] * grid[1] + c3[:, 1]) * grid[2] + c3[:, 2]
    order = np.argsort(flat, kind="stable")
    local = (frac * box - (c3 + 0.5) * h)[order]
    count = np.bincount(flat, minlength=cfg.n_cells)
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    print(f"cells {tuple(cfg.grid)}, {cfg.n_offsets} offsets; atoms a cell: "
          f"mean {count.mean():.4f}, sd {count.std():.4f}, max "
          f"{count.max()}, share above 32 {np.mean(count > 32):.4f}")

    parts = []
    for c in range(cfg.n_cells):
        p = [local[start[c] + a:start[c] + min(a + 32, count[c])]
             for a in range(0, count[c], 32)]
        parts.append([(len(q), q.min(0), q.max(0)) for q in p])
    diag = useful = picked = skipped = 0.0
    cut = cfg.cutoff
    for o in range(cfg.n_offsets):
        shift = cfg.offsets[o] * h
        for c in range(cfg.n_cells):
            b = cfg.nbr_map[c, o]
            useful += count[c] * count[b]
            for na, alo, ahi in parts[c]:
                for nb, blo, bhi in parts[b]:
                    diag += max(na, nb)
                    lo = min(na, nb)
                    if o == 0:
                        cost = nb
                    elif lo <= BCAST_MAX and max(na, nb) >= lo + 4:
                        cost = BCAST_STEP * lo + BCAST_SUM
                    else:
                        cost = max(na, nb)
                    picked += cost
                    gap = np.maximum(0.0, np.maximum(blo + shift - ahi,
                                                     alo - bhi - shift))
                    if o != 0 and np.sqrt(np.sum(gap * gap)) >= cut:
                        skipped += cost
    print(f"diagonal walk: {diag:.0f} warp-steps, {diag / (useful / 32):.4f}"
          f" x the useful pairs over 32")
    print(f"walk picked by tile_pair: {picked / diag:.4f} of the diagonal "
          f"walk's cost; in tiles beyond the cutoff: {skipped / picked:.4f}"
          f" of it; left: {(picked - skipped) / diag:.4f}")


if __name__ == "__main__":
    main()

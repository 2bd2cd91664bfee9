#!/usr/bin/env python3
"""The port's mesh across real CUDA cards, against one card.

    python3 chip_mesh_cards.py [--skip-atlas]

Needs at least two visible cards (four to lay the restart axis over four).
Prints, with the cards' names and power limits:

1. the main path's CD factorize (bench.py's make_counts(2700, 10000), 2000
   HVGs, K=5..13 x 100 restarts, f32) on one card and on the restart axis
   over 2 and over 4 cards (``stages.factorize_k(mesh=)``), in turns
   (single, 4, 2, 2, 4, single): each layout's walls, and whether every
   layout gave the single card's spectra bits and sweeps; then K=13 under
   torch.profiler on each layout (wall, device-busy seconds summed over
   the cards);
2. unless --skip-atlas, the same comparison at a device-bound size:
   chip_smoke.py's atlas counts (100,000 cells x 20,000 genes, 2,000 HVGs),
   K=12 x 30 restarts from the CSR, one turn of each layout;
3. the cell axis over 2 cards (restart 1 x cell 2), CD at K=10 x 100 on the
   main path's X: wall, sweeps, consensus against the single card's
   (relative SSE, bound 1e-4), and ``sum_shards`` of the H half's partial
   products (2 x 100 x 2000 x 16 f32) with the second shard on the other
   card against both shards on one card.

Exits 1 if a layout leaves the single card's bits or the consensus bound;
exits 2 with fewer than two cards.
"""

import argparse
import json
import sys
import time

import numpy as np

import chip_smoke as cs

MESH_SSE = 1e-4


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-atlas", action="store_true")
    args = ap.parse_args()
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print("chip_mesh_cards: needs two CUDA cards", file=sys.stderr)
        return 2

    from cnmf_tpu_torch.ops.kernel_lib import load_library
    from cnmf_tpu_torch.parallel.collectives import sum_shards
    from cnmf_tpu_torch.parallel.mesh import build_mesh
    from cnmf_tpu_torch.pipeline import stages

    card = cs.card_line()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    t0 = time.perf_counter()
    load_library()
    print(f"[cards] {n_cards} x {card}; build {time.perf_counter() - t0:.2f} s",
          flush=True)
    layouts = {"single": None}
    for n in (4, 2):
        if n <= n_cards:
            layouts[f"restart{n}"] = build_mesh(cards[:n], cell_axis=1)
    order = list(layouts) + list(reversed(layouts))
    ok = True

    def sync_wall(t0):
        for d in cards:
            torch.cuda.synchronize(d)
        return time.perf_counter() - t0

    def compare_layouts(label, X_host, Xd, ks, seeds_k, kwargs, turns):
        nonlocal ok
        walls = {name: [] for name in layouts}
        ref, same = {}, {name: True for name in layouts}
        for name in turns:
            t0 = time.perf_counter()
            for k in ks:
                spec, n_it, _ = stages.factorize_k(
                    X_host, Xd, k, seeds_k[k], kwargs, mesh=layouts[name])
                if k not in ref:
                    ref[k] = (spec, n_it)
                same[name] &= bool(np.array_equal(spec, ref[k][0])
                                   and np.array_equal(n_it, ref[k][1]))
            walls[name].append(sync_wall(t0))
        ok &= all(same.values())
        print(f"[{label}] walls s " + json.dumps(
            {n: [round(w, 3) for w in v] for n, v in walls.items()})
            + "; single card's bits and sweeps " + json.dumps(same),
            flush=True)
        return ref

    # 1. the main path
    counts = cs.make_counts(2700, 10000)
    X_host, Xd = cs.path_input(counts, 2000, cards[0])
    ks, n_iter = list(range(5, 14)), 100
    cd = stages.nmf_run_params()
    grid, seeds = stages.replicate_seeds(ks, n_iter, 14)
    seeds_k = {k: seeds[[i for i, (kk, _) in enumerate(grid) if kk == k]]
               for k in ks}
    ref = compare_layouts(f"main CD K={ks[0]}..{ks[-1]} x {n_iter}", X_host,
                          Xd, ks, seeds_k, cd, order)
    prof = {}
    for name, mesh in layouts.items():
        _, w, busy, _ = cs.profiled(lambda: stages.factorize_k(
            X_host, Xd, ks[-1], seeds_k[ks[-1]], cd, mesh=mesh))
        prof[name] = f"{w:.3f} s wall, {busy:.3f} s busy"
    print(f"[main profiled K={ks[-1]}] " + json.dumps(prof), flush=True)

    # 2. a device-bound size
    if not args.skip_atlas:
        t0 = time.perf_counter()
        A = cs.atlas_counts(cards[0])
        prep = stages.prepare_arrays(A, num_highvar_genes=cs.ATLAS_HVG)
        del A
        from cnmf_tpu_torch.ops.device_densify import to_device_dense

        Ad = to_device_dense(prep.norm, np.float32, cards[0])
        _, a_seeds = stages.replicate_seeds([cs.ATLAS_K], cs.ATLAS_RESTARTS,
                                            14)
        print(f"[atlas] data and prepare {sync_wall(t0):.3f} s", flush=True)
        compare_layouts(f"atlas CD K={cs.ATLAS_K} x {cs.ATLAS_RESTARTS}",
                        prep.norm, Ad, [cs.ATLAS_K], {cs.ATLAS_K: a_seeds},
                        cd, list(layouts))
        del Ad, prep

    # 3. the cell axis over two cards
    k = 10
    cell = build_mesh(cards[:2], cell_axis=2)
    t0 = time.perf_counter()
    spec_c, n_c, _ = stages.factorize_k(X_host, Xd, k, seeds_k[k], cd,
                                        mesh=cell)
    cell_s = sync_wall(t0)
    prep = stages.prepare_arrays(counts, num_highvar_genes=2000)
    tpm = torch.as_tensor(np.ascontiguousarray(prep.tpm, dtype=np.float32),
                          device=cards[0])

    def consensus(spec):
        return stages.consensus_arrays(stages.combine_arrays(list(spec)), k,
                                       Xd, tpm, prep.tpm_std, prep.hvg_idx, cd)

    gap = cs.consensus_gap(consensus(spec_c), consensus(ref[k][0]))
    ok &= gap <= MESH_SSE
    g = torch.Generator(device=cards[0]).manual_seed(9)
    part = torch.rand(100, 2000, 16, device=cards[0], generator=g)
    sums = {}
    for name, devs in (("one card", cards[:1] * 2), ("two cards", cards[:2])):
        parts = [part.to(d) for d in devs]
        sum_shards(parts)
        t0 = time.perf_counter()
        for _ in range(20):
            sum_shards(parts)
        sums[name] = round(sync_wall(t0) / 20 * 1e3, 4)
    print(f"[cell 2 cards] CD K={k} x {n_iter}: {cell_s:.3f} s, sweeps "
          f"{n_c.max()}/{n_c.mean():.1f} (single {ref[k][1].max()}/"
          f"{ref[k][1].mean():.1f}), consensus rel SSE {gap:.1e} (bound "
          f"{MESH_SSE:g}); sum_shards of 2 x {part.numel() * 4 / 1e6:.1f} MB "
          "ms " + json.dumps(sums), flush=True)
    print(card)
    print(json.dumps({"ok": bool(ok), "cards": n_cards}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

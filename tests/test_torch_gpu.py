"""Kernel-vs-plain tests of the port that need a CUDA device.

Marked `gpu`; they skip (from a fixture) where torch sees no CUDA device.
This file imports no JAX, so it also runs on a machine without it:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import pytest
import torch

from flipviscosity3d_torch import _build, smoke
from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.ops import pallas_mg as pm
from flipviscosity3d_torch.ops import pallas_particles as pp
from flipviscosity3d_torch.scripts import gather_perf_probe as probe
from flipviscosity3d_torch.scripts import midpoints, pallas_hw_check
from flipviscosity3d_torch.scripts import pallas_particle_proto as proto
from flipviscosity3d_torch.scripts.bench import BENCH_PARTICLES, DT, bench_scene
from flipviscosity3d_torch.scripts.mg_pallas_bench import v_cycle_plain
from flipviscosity3d_torch.solvers import multigrid as mg
from flipviscosity3d_torch.solvers import viscosity as vs

# K3 / K4: every level above the coarsest of both hierarchies at 32^3, and
# ragged shapes drawn from I in {1, 2, 3, 17}, J and K in {1, 7, 31, 33, 65},
# nb in {1, 3}, which straddle the kernels' 16 x 16 column tiles and their
# i-chunks
LEVEL_SHAPES = [(1, 32, 32, 32), (1, 16, 16, 16), (3, 33, 33, 33),
                (3, 17, 17, 17), (3, 9, 9, 9)]
RAGGED_SHAPES = [(1, 1, 1, 1), (3, 2, 7, 31), (1, 3, 33, 65),
                 (3, 17, 65, 7), (1, 17, 31, 33), (3, 1, 65, 65),
                 (1, 2, 1, 33), (3, 3, 31, 1), (1, 17, 7, 7),
                 (3, 17, 33, 31), (1, 3, 65, 1), (3, 2, 33, 33),
                 (1, 1, 31, 65)]
# the planes a block marches through: the wrapper's own choice (4 at these
# sizes), 2, and all of I in one chunk
CHUNKS = ["auto", 2, "all"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_versions(cuda):
    sim = bench_scene(cuda, 32)
    records = smoke.check_kernels(sim.state, sim.cfg)
    assert [r["name"] for r in records] == [
        "scatter_p2g_table", "gather_mac", "mg_down", "mg_up",
        "scatter_p2g_table_stale", "gather_rows8",
        "scatter_p2g_table_folded", "scatter_p2g_table_stale_folded",
        "gather_rows", "detile", "scatter_revisit", "gather_revisit",
        "tile_scatter", "tile_gather", "gather_mac_one_grid",
        "viscosity_operator", "compute_volume_grids",
        "build_viscosity_system", "liquid_sdf_from_table"]
    for r in records:
        assert r["ok"], r
        assert r["bound_by"] in ("bytes", "operations")
        assert 0 < r["bound_ms"] and 0 < r["ms"]


def _edge_stream(gen, dev):
    """Positions on a 32^3 grid built to hit K1's edges: a cell of 40
    particles (more than a warp's batch), a tile of 5,000 (more than 4,096),
    tiles left empty, and 20,000 spread over the lower half in y -> (pos,
    shape, dx)."""
    shape, dx = (32, 32, 32), 1.0 / 32
    lo = torch.tensor([0.0, 0.0, 0.0], device=dev)
    hi = torch.tensor([1.0, 0.5, 1.0], device=dev)
    spread = lo + (hi - lo) * torch.rand((20_000, 3), generator=gen,
                                         device=dev)
    one_cell = (torch.tensor([9.0, 3.0, 17.0], device=dev) + torch.rand(
        (40, 3), generator=gen, device=dev)) * dx
    one_tile = (torch.tensor([16.0, 8.0, 0.0], device=dev) + 8.0 * torch.rand(
        (5_000, 3), generator=gen, device=dev)) * dx
    return torch.cat([spread, one_cell, one_tile]), shape, dx


@pytest.mark.gpu
def test_scatter_edge_streams_match_plain_version(cuda):
    """K1 on _edge_stream against scatter_p2g_table_ref at caps 1 and 32,
    both sums layouts and pallas_split_terms 3, 1 and 2: sums within rtol
    1e-5 / atol 1e-6 of max|sums|, slot tables torch.equal; the stream holds
    empty tiles, a cell past 32 particles and a tile past 4,096. Then K5 the
    same way against scatter_p2g_table_stale_ref (counts torch.equal too)
    over two stale orders of the sorted stream: its chunks of 512 shuffled,
    through plan_pass_a at budget 1, which leaves the particles of a
    chunk's second tile uncovered; and each chunk's particles shuffled too,
    at budget 8, which covers them all (the tile past 4,096 and the cell
    past 32 spread over the warps of their chunks)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    pos, shape, dx = _edge_stream(gen, cuda)
    vel = torch.randn(pos.shape, generator=gen, device=cuda)
    stream = pp.tiled_sort(pos, vel, dx, shape)
    per_tile = torch.bincount(stream.key // pp.W, minlength=64)
    assert int((per_tile == 0).sum()) > 0 and int(per_tile.max()) > 4096
    assert int(stream.rank.max()) >= 39
    for cap in (1, 32):
        args = (stream.pos, stream.vel, stream.key, stream.rank, shape, dx,
                cap)
        for fold in (False, True):
            for terms in (3, 1, 2):
                got = pp.scatter_p2g_table(*args, fold_sums=fold, terms=terms)
                want = pp.scatter_p2g_table_ref(*args, fold_sums=fold,
                                                terms=terms)
                what = (cap, fold, terms)
                torch.testing.assert_close(
                    got[0], want[0], rtol=1e-5,
                    atol=1e-6 * float(want[0].abs().max()), msg=str(what))
                assert torch.equal(got[1], want[1]), what

    n = pos.shape[0]
    chunks = torch.randperm(pp.n_chunks(n), generator=gen, device=cuda)
    by_chunk = torch.cat([torch.arange(c * pp.C, min(n, (c + 1) * pp.C),
                                       device=cuda) for c in chunks.tolist()])
    within = torch.cat([part[torch.randperm(part.numel(), generator=gen,
                                            device=cuda)]
                        for part in by_chunk.split(pp.C)])
    for label, order, budget in (("chunks", by_chunk, 1),
                                  ("particles", within, 8)):
        p, v, key = (t[order].contiguous()
                     for t in (stream.pos, stream.vel, stream.key))
        plan = pp.plan_pass_a(key, shape, budget, 3.0)
        covered = int(plan.covered.sum())
        assert 0 < covered < n if budget == 1 else covered == n, label
        for cap in (1, 32):
            for fold in (False, True):
                for terms in (3, 1, 2):
                    got = pp.scatter_p2g_table_stale(
                        p, v, key, plan, shape, dx, cap, fold_sums=fold,
                        terms=terms)
                    want = pp.scatter_p2g_table_stale_ref(
                        p, v, key, plan.covered, shape, dx, cap,
                        fold_sums=fold, terms=terms)
                    what = (label, cap, fold, terms)
                    torch.testing.assert_close(
                        got[0], want[0], rtol=1e-5,
                        atol=1e-6 * float(want[0].abs().max()), msg=str(what))
                    assert torch.equal(got[1], want[1]), what
                    assert torch.equal(got[2], want[2]), what
    per_tile = pp.to_tile_major(want[2][..., None]).sum(dim=(1, 2))
    assert int(per_tile.max()) > 4096 and int(want[2].max()) > 32


@pytest.mark.gpu
def test_gather_mac_orders_match_plain_version(cuda):
    """K2 torch.equal to gather_mac_ref at pallas_split_terms 3, 1 and 2,
    with two grids and one, on keys sorted, shuffled, and of midpoints of
    which some lie outside the domain."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    pos, shape, dx = _edge_stream(gen, cuda)
    cfg = SimConfig(isize=32, jsize=32, ksize=32, dx=dx)
    faces = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
    grids = [[torch.randn(fs, generator=gen, device=cuda) for fs in faces]
             for _ in range(2)]
    key = pp.key_of_position(pos, dx, shape)
    key_s, (pos_s,) = pp.sort_by_key(key, (pos,))
    shuffle = torch.randperm(pos.shape[0], generator=gen, device=cuda)
    mx, my, mz, key_m, outside = midpoints(pos_s, cfg, gen)
    assert outside > 0
    orders = {"sorted": (*pos_s.unbind(1), key_s),
              "shuffled": (*pos_s[shuffle].unbind(1), key_s[shuffle]),
              "midpoints": (mx, my, mz, key_m)}
    for label, (px, py, pz, keys) in orders.items():
        px, py, pz = (a.contiguous() for a in (px, py, pz))
        for n_grids in (1, 2):
            gs = [[g[c] for g in grids[:n_grids]] for c in range(3)]
            for terms in (3, 1, 2):
                got = pp.gather_mac(px, py, pz, keys, *gs, dx, shape,
                                    terms=terms)
                want = pp.gather_mac_ref(px, py, pz, keys, *gs, dx, shape,
                                         terms=terms)
                assert torch.equal(got, want), (label, n_grids, terms)


@pytest.mark.gpu
def test_main_path_launches_every_kernel(cuda, tmp_path, monkeypatch):
    """The three main paths at 32^3 launch the six unfolded kernels, K2
    with one grid (pass B), K13, K14's two wrappers and K15; the CLI's paths
    with the large-grid threshold lowered to 32^3 launch the two folded
    ones; the hardware-check path launches the four kernels of the column
    path."""
    launched = set()
    for _, dt, lift, overrides in smoke.MAIN_PATHS:
        result = smoke.run_main_path(cuda, 32, 1, dt=dt, lift=lift,
                                     **overrides)
        assert result["failures"] == []
        launched |= {k for k, c in result["launches"].items() if c > 0}
    assert launched == {fn.__name__ for fn, _, _ in smoke.KERNELS[:6]} | {
        "gather_mac_one_grid", "liquid_sdf_from_table",
        *smoke.VISCOSITY_KERNELS}
    monkeypatch.setattr(pp, "FOLD_CELLS", 32 ** 3)
    for name, dt, lift, overrides in smoke.MAIN_PATHS[:2]:
        result = smoke.run_scene_path(cuda, tmp_path, name, 32, 1, dt=dt,
                                      lift=lift, **overrides)
        assert result["failures"] == []
        launched |= {k for k, c in result["launches"].items() if c > 0}
    assert launched == {fn.__name__ for fn, _, _ in smoke.KERNELS[:8]} | {
        "gather_mac_one_grid", "liquid_sdf_from_table",
        *smoke.VISCOSITY_KERNELS}
    monkeypatch.undo()
    result = smoke.run_hw_check(cuda, 32, 65_536, 64, 30_000,
                                log=lambda line: None)
    assert result["failures"] == []
    # and K1 once, whose sums pallas_hw_check holds against its oracle
    assert {k for k, c in result["launches"].items() if c > 0} == {
        "scatter_p2g_table", *smoke.HW_CHECK_KERNELS}


@pytest.mark.gpu
def test_table_stream_and_proto_paths_and_kernels(cuda):
    """The bench run at 32^3 on the table and stream engines launches the
    solvers' kernels K3, K4, K13 and K14 and no particle kernel; the
    prototype's path at 32^3 launches K11 and K12 and its checks pass; K11
    and K12 match their plain versions at the prototype's 128^3 shapes
    (_check_proto_kernels_at_128)."""
    for name, dt, lift, overrides in smoke.ENGINE_PATHS:
        result = smoke.run_main_path(cuda, 32, 1, dt=dt, lift=lift,
                                     log=lambda line: None, **overrides)
        assert result["failures"] == [], name
        assert result["sim"].cfg.particle_engine == name
        assert {k for k, c in result["launches"].items() if c > 0} == {
            "mg_down", "mg_up", *smoke.VISCOSITY_KERNELS}, name
    result = smoke.run_proto(cuda, 32, log=lambda line: None)
    assert result["failures"] == [] and result["result"]["ok"]
    assert {k for k, c in result["launches"].items() if c > 0} == set(
        smoke.PROTO_KERNELS)
    _check_proto_kernels_at_128(cuda)
    _check_tile_scatter_edge_stream(cuda)


def _check_tile_scatter_edge_stream(cuda):
    """K11 over _edge_stream (a tile past 4,096 particles, a cell past 32,
    empty tiles) at caps 1, 16 and 32: slot tables torch.equal to
    tile_scatter_ref's, sums within rtol 1e-5 / atol 1e-6 of their largest
    magnitude."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    pos, shape, dx = _edge_stream(gen, cuda)
    vel = torch.randn(pos.shape, generator=gen, device=cuda)
    payload, starts, _ = proto.sort_particles(pos, vel, dx, shape)
    per_tile = starts[1:] - starts[:-1]
    assert int(per_tile.max()) > 4096 and int((per_tile == 0).sum()) > 0
    assert int(payload[7].max()) >= 39
    nt = proto.tile_counts(shape)
    for cap in (1, 16, 32):
        got = proto.tile_scatter(starts, payload, nt, dx, cap)
        want = proto.tile_scatter_ref(starts, payload, nt, dx, cap)
        assert torch.equal(got[..., 108:], want[..., 108:]), cap
        torch.testing.assert_close(
            got[..., :108], want[..., :108], rtol=1e-5,
            atol=1e-6 * float(want[..., :108].abs().max()), msg=str(cap))


def _check_proto_kernels_at_128(cuda):
    """K11 and K12 at the prototype's 128^3 shapes (make_scene(128):
    4,456,448 particles, cap 16, F = 128): K11 bit-equal between two calls,
    its slot table equal to the plain version's and its sums within rtol
    1e-5 / atol 1e-6 of their largest magnitude (the plain index_add_ adds
    with atomics); K12 torch.equal, its pad rows zero."""
    pos, vel, dx, shape = proto.make_scene(128)
    payload, starts, spans = proto.sort_particles(
        torch.from_numpy(pos).to(cuda), torch.from_numpy(vel).to(cuda), dx,
        shape)
    nt = proto.tile_counts(shape)
    got = proto.tile_scatter(starts, payload, nt, dx, 16)
    assert torch.equal(got, proto.tile_scatter(starts, payload, nt, dx, 16))
    want = proto.tile_scatter_ref(starts, payload, nt, dx, 16)
    assert torch.equal(got[..., 108:], want[..., 108:])
    torch.testing.assert_close(got[..., :108], want[..., :108], rtol=1e-5,
                               atol=1e-6 * float(want[..., :108].abs().max()))
    del got, want
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    cols = torch.randn((proto.n_blocks_of(shape), proto.W, 128),
                       generator=gen, device=cuda)
    lanes = payload[:, :spans.shape[0] * proto.C]
    rows = proto.tile_gather(spans, lanes, cols)
    assert torch.equal(rows, proto.tile_gather_ref(spans, lanes, cols))
    assert not rows[pos.shape[0]:].any()


@pytest.mark.gpu
def test_column_kernels_match_plain_versions(cuda):
    """K7-K10 against their plain versions at 32^3: K7 on an f32 and a bf16
    image, 108 of 112 lanes and 54, unsorted keys and a partial coverage;
    K8 at F = 108, 54 and 3 and on a non-cubic grid; K9 within the probe's
    tolerance and bit-equal between two calls; K10 exact, its pad rows
    zero. Exact where the kernel copies."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    shape, n = (32, 32, 32), 100_001
    n_tiles = 32 ** 3 // pp.W
    keys = torch.randint(0, 32 ** 3, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    covered = torch.rand(n, generator=gen, device=cuda) < 0.7
    for dtype in (torch.float32, torch.bfloat16):
        image = torch.randn((n_tiles, 112, pp.W), generator=gen,
                            device=cuda).to(dtype)
        for f in (108, 54):
            for cov in (None, covered):
                got = pp.gather_rows(keys, cov, image, f)
                assert got.dtype == torch.float32
                assert torch.equal(got, pp.gather_rows_ref(keys, cov, image,
                                                           f))
    for grid, f in ((shape, 108), (shape, 54), (shape, 3), ((16, 8, 24), 6)):
        y = torch.randn((grid[0] * grid[1] * grid[2] // pp.W, pp.W, f),
                        generator=gen, device=cuda)
        assert torch.equal(pp.detile(y, grid), pp.from_tile_major(y, grid))
    key_s = torch.sort(keys).values
    vals = torch.randn((pp.n_chunks(n), pp.C, probe.F), generator=gen,
                       device=cuda)
    out = probe.scatter_revisit(key_s, vals, n_tiles)
    assert torch.equal(out, probe.scatter_revisit(key_s, vals, n_tiles))
    torch.testing.assert_close(
        out, probe.scatter_revisit_ref(key_s, vals, n_tiles),
        rtol=probe.SCATTER_RTOL, atol=probe.SCATTER_ATOL)
    cols = torch.randn((n_tiles, pp.W, probe.F), generator=gen, device=cuda)
    rows = probe.gather_revisit(keys, cols)
    assert torch.equal(rows, probe.gather_revisit_ref(keys, cols))
    assert rows.shape[0] == pp.n_chunks(n) * pp.C and not rows[n:].any()


@pytest.mark.gpu
def test_unfused_route_matches_gather_mac_on_the_card(cuda):
    """build_mac_columns -> K7 -> combine_mac_samples against K2 on a 32^3
    state after two frames, f32 and bf16 images; and the hardware gate
    bites on the card: a tampered image fails it."""
    sim = bench_scene(cuda, 32)
    sim.advance(DT)
    prev = (sim.state.u, sim.state.v, sim.state.w)
    sim.advance(DT)
    rec = smoke.check_unfused_route(sim.state, prev, sim.cfg,
                                    log=lambda line: None)
    assert rec["ok"], rec
    assert len(rec["checks"]) == 2 and not rec["split"]
    quiet = dict(log=lambda line: None)
    assert pallas_hw_check.run(cuda, **quiet)["ok"]
    assert not pallas_hw_check.run(cuda, tamper=lambda c: c + 1.0,
                                   **quiet)["ok"]


@pytest.mark.gpu
def test_cli64_resumes_on_the_card(cuda, tmp_path):
    result = smoke.run_cli64(cuda, tmp_path, resolution=32)
    assert result["failures"] == []
    assert result["resumed_final_max_abs_diff"] <= 1e-5


@pytest.mark.gpu
def test_folded_kernels_match_unfolded_where_they_fold_by_themselves(
        cuda, monkeypatch):
    """check_kernels as the smoke run calls it at 256^3: on a grid that
    folds by itself, the plain scatters in runs of particles."""
    monkeypatch.setattr(pp, "FOLD_CELLS", 32 ** 3)
    sim = bench_scene(cuda, 32)
    assert pp.large_grid(sim.cfg.grid_shape)
    for r in smoke.check_kernels(sim.state, sim.cfg, ref_slabs=16):
        assert r["ok"], r


@pytest.mark.gpu
def test_fluid_simulation_defaults_to_the_card(cuda):
    from flipviscosity3d_torch import FluidSimulation
    assert FluidSimulation().device.type == "cuda"


# runtime calls in which the host waits for the device
SYNC_CALLS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D"}
# host waits a substep with viscosity that no trace.read makes (PERF.md
# section 7): the blocking copies of the solves' tolerances to the card
# (solvers/viscosity.py, 1; solvers/pressure.py, 2) and torch.linalg.inv's
# error check in the dense coarse inverse (solvers/multigrid.py, 1 a solve)
IMPLICIT_SYNCS = 5


@pytest.mark.gpu
def test_traced_frame_times_its_stages_on_the_stream(cuda, tmp_path):
    """One 32^3 frame under torch.profiler: every stage has a positive
    stream time, the stages of the substeps sum to at most the substeps'
    and the frame's to at most its advance span; and the tracing waits on
    nothing: the frame's host waits are exactly its counted reads and the
    implicit syncs, and none is a cudaEventSynchronize."""
    import json

    from torch.profiler import ProfilerActivity, profile

    sim = bench_scene(cuda, 32)
    sim.advance(DT)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        d = sim.advance(DT)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    data = json.loads((tmp_path / "trace.json").read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    (frame,) = [e for e in events if e.get("cat") == "user_annotation"
                and e["name"] == "advance"]
    syncs = [e["name"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and e["name"] in SYNC_CALLS
             and frame["ts"] <= e["ts"] <= frame["ts"] + frame["dur"]]
    st = {k: s["stream_ms"] for k, s in d.stages.items()}
    stages = ("pass_a", "liquid_sdf", "p2g_combine", "grid_update",
              "extrapolate", "viscosity_build", "viscosity_solve",
              "viscosity_apply", "pressure_build", "pressure_solve",
              "pressure_apply", "pcg.apply_A", "pcg.apply_M",
              "viscosity_operator", "viscosity_precond", "g2p",
              "midpoint_sample", "pushback", "substep", "advance")
    assert all(st[k] > 0 for k in stages), st
    eps = 1e-2   # ms: two timing events' resolution, many times over
    assert sum(st[k] for k in ("pass_a", "liquid_sdf", "p2g_combine",
                               "grid_update", "g2p", "midpoint_sample",
                               "pushback")) <= st["substep"] + eps
    assert st["cfl_read"] + st["substep"] + st["frame_reads"] <= \
        st["advance"] + eps
    assert "cudaEventSynchronize" not in syncs
    assert len(syncs) == sum(d.host_reads.values()) + \
        IMPLICIT_SYNCS * d.substeps, (syncs, d.host_reads)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    b = torch.zeros((1, 8, 8, 8), device=cuda)
    links = (b, b, b)
    with pytest.raises(ValueError):
        pm.mg_down(b.double(), links, b.double(), 0.8)
    with pytest.raises(ValueError):
        pm.mg_down(b, links, b.transpose(1, 2), 0.8)
    pos = torch.zeros((4, 3), device=cuda)
    key = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        pp.scatter_p2g_table(pos, pos, key, key, (8, 8, 8), 1 / 8, 4)
    plan = pp.plan_pass_a(key.int(), (8, 8, 8))
    with pytest.raises(ValueError):
        pp.scatter_p2g_table_stale(pos, pos, key, plan, (8, 8, 8), 1 / 8, 4)
    with pytest.raises(ValueError):
        pp.gather_rows8(key.int(), plan.covered.int(),
                        torch.zeros((9, 9, 9), device=cuda), (8, 8, 8))
    image = torch.zeros((1, 8, pp.W), device=cuda)
    with pytest.raises(ValueError):
        pp.gather_rows(key, None, image)               # int64 keys
    with pytest.raises(ValueError):
        pp.gather_rows(key.int(), None, image.half())  # neither f32 nor bf16
    with pytest.raises(ValueError):
        pp.gather_rows(key.int(), None, image, 9)      # more than its lanes
    with pytest.raises(ValueError):
        pp.detile(torch.zeros((1, pp.W, 3), device=cuda).double(), (8, 8, 8))
    with pytest.raises(ValueError):
        probe.scatter_revisit(key.int(), torch.zeros((1, 4, 128),
                                                     device=cuda), 1)
    with pytest.raises(ValueError):
        probe.gather_revisit(key, torch.zeros((1, pp.W, 128), device=cuda))
    starts = torch.zeros(2, dtype=torch.int32, device=cuda)
    payload = torch.zeros((8, 1024), device=cuda)
    nt = (1, 1, 1)
    with pytest.raises(ValueError):
        proto.tile_scatter(starts.long(), payload, nt, 1 / 8, 4)
    with pytest.raises(ValueError):
        proto.tile_scatter(starts, payload.double(), nt, 1 / 8, 4)
    with pytest.raises(ValueError):
        proto.tile_scatter(starts, payload, (2, 1, 1), 1 / 8, 4)  # 1 tile
    with pytest.raises(ValueError):
        proto.tile_scatter(starts, payload, nt, 1 / 8, 33)   # past 32
    spans = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    cols = torch.zeros((1, pp.W, 128), device=cuda)
    with pytest.raises(ValueError):
        proto.tile_gather(spans.long(), payload, cols)
    with pytest.raises(ValueError):
        proto.tile_gather(spans, payload[:, :512], cols)     # 2 chunks
    with pytest.raises(ValueError):
        proto.tile_gather(spans, payload, cols.double())
    with pytest.raises(ValueError):
        proto.tile_gather(spans, payload.t().contiguous().t(), cols)
    factors, diag, x = smoke.random_viscosity_operator(
        VISC_SHAPES["cube"], torch.Generator(device=cuda), cuda)
    with pytest.raises(ValueError):                      # f64 x
        vs.viscosity_operator(factors, (x[0].double(),) + x[1:], diag)
    with pytest.raises(ValueError):                      # f64 diag
        vs.viscosity_operator(factors, x, (diag[0].double(),) + diag[1:])
    cpu_factor = [dict(f) for f in factors]
    cpu_factor[1]["t"] = cpu_factor[1]["t"].cpu()
    with pytest.raises(ValueError):                      # a CPU factor
        vs.viscosity_operator(cpu_factor, x, diag)
    with pytest.raises(ValueError):                      # CUDA x, CPU x
        vs.viscosity_operator(factors, (x[0], x[1].cpu(), x[2]), diag)
    with pytest.raises(ValueError):                      # non-contiguous
        vs.viscosity_operator(factors, (x[0], x[1], x[2].transpose(0, 1)),
                              diag)
    with pytest.raises(ValueError):                      # a factor's shape
        vs.viscosity_operator(
            [dict(f, r=f["r"][:-1].contiguous()) for f in factors], x, diag)
    with pytest.raises(ValueError):                      # not 3-D
        vs.viscosity_operator(factors, (x[0][None],) + x[1:], diag)
    # K14: inputs on two devices
    gen = torch.Generator(device=cuda)
    phi = smoke.visc_build_phi((8, 8, 8), "sphere", gen, cuda)
    cfg = SimConfig(isize=8, jsize=8, ksize=8, dx=1 / 8)
    vols = vs.compute_volume_grids(phi, cfg)
    u, v, w, states, visc = smoke.visc_build_inputs(phi, _faces(8, 8, 8),
                                                    gen, cuda)
    with pytest.raises(ValueError):                      # a CPU velocity
        vs.build_viscosity_system(u, v.cpu(), w, vols, states, visc, 0.01,
                                  cfg)
    with pytest.raises(ValueError):                      # a CPU solid mask
        vs.build_viscosity_system(
            u, v, w, vols, vs.FaceStates(states.solid_u.cpu(),
                                         states.solid_v, states.solid_w),
            visc, 0.01, cfg)
    with pytest.raises(ValueError):                      # a CPU volume grid
        vs.build_viscosity_system(
            u, v, w, dataclasses.replace(vols, center=vols.center.cpu()),
            states, visc, 0.01, cfg)
    with pytest.raises(ValueError):                      # CPU viscosity
        vs.build_viscosity_system(u, v, w, vols, states, visc.cpu(), 0.01,
                                  cfg)
    with pytest.raises(ValueError):                      # non-contiguous
        vs.compute_volume_grids(phi.transpose(0, 1), cfg)
    # K15: a CPU solid phi, an f64 table, a table of another cap
    table = smoke.sdf_table((8, 8, 8), 4, "mixed", gen, cuda)
    with pytest.raises(ValueError):
        pp.liquid_sdf_from_table(table, 4, (8, 8, 8), 1 / 8, 0.1, phi.cpu())
    with pytest.raises(ValueError):
        pp.liquid_sdf_from_table(table.double(), 4, (8, 8, 8), 1 / 8, 0.1,
                                 phi)
    with pytest.raises(ValueError):
        pp.liquid_sdf_from_table(table, 3, (8, 8, 8), 1 / 8, 0.1, phi)


def _faces(i, j, k):
    return ((i + 1, j, k), (i, j + 1, k), (i, j, k + 1))


# K15 beyond smoke's cases: grids that straddle its 14 x 30 target columns
# and its chunks of planes, a single cell, and odd caps (the kernel reads
# slots in pairs)
SDF_RAGGED = {"ragged": ((33, 29, 61), 5, "mixed"),
              "one_cell": ((1, 1, 1), 3, "full"),
              "thin": ((2, 45, 3), 1, "mixed"),
              "cap32": ((9, 15, 31), 32, "mixed")}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(smoke.SDF_CASES) + list(SDF_RAGGED))
def test_liquid_sdf_equals_its_plain_version(cuda, name):
    """K15 torch.equal to the plain composition (table_fields,
    liquid_sdf_from_particles) with finalize and without, on smoke's cases
    and the ragged ones."""
    shape, cap, fill = {**smoke.SDF_CASES, **SDF_RAGGED}[name]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(21)
    table = smoke.sdf_table(shape, cap, fill, gen, cuda)
    dx = 1.0 / max(shape)
    solid = torch.randn(shape, generator=gen, device=cuda) * dx
    _build.reset_launch_counts()
    checks = smoke.sdf_checks("", table, cap, shape, dx,
                              SimConfig.particle_radius_factor * dx, solid)
    assert all(c["ok"] for c in checks), checks
    assert pp.liquid_sdf_from_table.launches == 2


@pytest.mark.gpu
def test_liquid_sdf_on_the_tables_k1_and_k5_write(cuda):
    """K15 torch.equal to its plain version on the tables that K1 (the
    sorted stream) and K5 (both stale orders of smoke, the random one
    partly covered) write for the 32^3 bench pool."""
    sim = bench_scene(cuda, 32)
    cfg, state = sim.cfg, sim.state
    shape, dx, cap = cfg.grid_shape, cfg.dx, cfg.sdf_cap
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    vel = torch.randn(state.pos.shape, generator=gen, device=cuda)
    stream = pp.tiled_sort(state.pos, vel, dx, shape)
    tables = {"K1": pp.scatter_p2g_table(stream.pos, stream.vel, stream.key,
                                         stream.rank, shape, dx, cap)[1]}
    for label, moved in smoke.stale_orders(stream.pos, cfg, gen).items():
        key = pp.key_of_position(moved, dx, shape)
        plan = pp.plan_pass_a(key, shape, cfg.pallas_passa_budget,
                              cfg.pallas_passa_factor)
        tables[f"K5 {label}"] = pp.scatter_p2g_table_stale(
            moved, vel, key, plan, shape, dx, cap)[1]
    for label, table in tables.items():
        checks = smoke.sdf_checks(f"{label}: ", table, cap, shape, dx,
                                  cfg.particle_radius, state.solid.center_phi)
        assert all(c["ok"] for c in checks), checks


@pytest.mark.gpu
def test_pallas_step_launches_k15_once_a_substep(cuda):
    """A warm and a timed frame of the bench path and of the stale path
    (K1's and K5's tables) at 32^3: K15 launches exactly once a substep."""
    for _, dt, lift, overrides in smoke.MAIN_PATHS[:2]:
        result = smoke.run_main_path(cuda, 32, 1, dt=dt, lift=lift,
                                     log=lambda line: None, **overrides)
        assert result["failures"] == []
        substeps = sum(f["substeps"] for f in result["frames"])
        assert result["launches"]["liquid_sdf_from_table"] == substeps


# K13: a small cube, an odd grid, the slab shapes of a 64^3 grid in 4 slabs
# as shard_step hands them (B + 2H = 28 rows on every component), and the
# 128^3 bench grid
VISC_SHAPES = {"cube": _faces(8, 8, 8), "odd": _faces(13, 18, 11),
               "slab": ((28, 64, 64), (28, 65, 64), (28, 64, 65)),
               "bench128": _faces(128, 128, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(VISC_SHAPES))
def test_viscosity_operator_equals_its_plain_version(cuda, name):
    """K13 torch.equal to viscosity_operator_ref on a random premasked
    operator, with the diagonal (a CG apply) and without it (the build's
    RHS coupling), and counted once a launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(13)
    factors, diag, x = smoke.random_viscosity_operator(VISC_SHAPES[name],
                                                       gen, cuda)
    before = vs.viscosity_operator.launches
    for d in (diag, None):
        got = vs.viscosity_operator(factors, x, d)
        want = vs.viscosity_operator_ref(factors, x, d)
        for c, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape
            assert torch.equal(g, w), (name, c, d is None)
    assert vs.viscosity_operator.launches == before + 2


def _slab_masks(faces, cfg, rank, spec, dev):
    """The rows' ranges of slab `rank` in the global domain, as
    shard_step's viscosity build makes them."""
    from flipviscosity3d_torch.parallel import shard_step as sh

    return tuple(
        sh._i_range_mask(faces[0][0], 1, cfg.isize, spec, rank, dev)
        & sh._jk_range_mask(fs, (1, 1), (cfg.jsize, cfg.ksize), dev)
        for fs in faces)


# K14: (liquid phi's shape, face shapes, viscosity's shape, slab rank) on a
# small cube, an odd grid, the 128^3 bench grid, and the first and an inner
# slab of a 64^3 grid in 4 slabs as shard_step hands them (B + 2H = 28
# rows on every component, the nodes one more), with their row masks
BUILD_CASES = {"cube": ((8, 8, 8), _faces(8, 8, 8), None, None),
               "odd": ((13, 18, 11), _faces(13, 18, 11), None, None),
               "bench128": ((128,) * 3, _faces(128, 128, 128), None, None),
               "slab0": ((28, 64, 64), VISC_SHAPES["slab"], (29, 65, 65), 0),
               "slab1": ((28, 64, 64), VISC_SHAPES["slab"], (29, 65, 65), 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("field", smoke.VISC_BUILD_FIELDS)
@pytest.mark.parametrize("name", list(BUILD_CASES))
def test_visc_build_equals_its_plain_version(cuda, name, field):
    """K14 torch.equal to compute_volume_grids_ref (the 7 grids) and
    build_viscosity_system_ref (in_mat, diag, vol, the 18 factors and rhs)
    on the card, each wrapper call counted: one launch of the volume
    kernel, two of the build (its assembly and RHS kernels)."""
    from flipviscosity3d_torch.parallel import shard_step as sh

    shape, faces, visc_shape, rank = BUILD_CASES[name]
    if rank is None:
        cfg = SimConfig(isize=shape[0], jsize=shape[1], ksize=shape[2],
                        dx=1.0 / max(shape))
        masks = None
    else:
        cfg = SimConfig(isize=64, jsize=64, ksize=64, dx=1.0 / 64)
        masks = _slab_masks(faces, cfg, rank,
                            sh.SlabSpec(n=4, B=16, H=6, cap=0, mig=0), cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(14)
    phi = smoke.visc_build_phi(shape, field, gen, cuda)
    before = (vs.compute_volume_grids.launches,
              vs.build_viscosity_system.launches)
    got = vs.compute_volume_grids(phi, cfg)
    want = vs.compute_volume_grids_ref(phi, cfg)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.shape == w.shape and g.dtype == w.dtype, f.name
        assert torch.equal(g, w), (name, field, f.name)
    u, v, w, states, visc = smoke.visc_build_inputs(phi, faces, gen, cuda,
                                                    visc_shape)
    sys_k = vs.build_viscosity_system(u, v, w, got, states, visc, 0.004, cfg,
                                      row_masks=masks)
    sys_p = vs.build_viscosity_system_ref(u, v, w, got, states, visc, 0.004,
                                          cfg, row_masks=masks)
    for part in ("in_mat", "diag", "vol", "rhs"):
        for c, (g, w) in enumerate(zip(getattr(sys_k, part),
                                       getattr(sys_p, part))):
            assert g.shape == w.shape and g.dtype == w.dtype, (part, c)
            assert torch.equal(g, w), (name, field, part, c)
    for c, (fk, fp) in enumerate(zip(sys_k.factors, sys_p.factors)):
        assert list(fk) == list(fp) == list(vs._KEYS)
        for key in vs._KEYS:
            assert torch.equal(fk[key], fp[key]), (name, field, c, key)
    assert (vs.compute_volume_grids.launches,
            vs.build_viscosity_system.launches) == (before[0] + 1,
                                                    before[1] + 2)


def _level_inputs(shape, gen, dev):
    """A random level: diag in [1, 2) with a tenth of it 0 (inv_diag's other
    branch), links in [0, 0.25) on every cell (the kernels must leave out
    the links past the edge as the plain version's zero x does), b, and a
    coarse xc."""
    diag = 1.0 + torch.rand(shape, generator=gen, device=dev)
    diag[torch.rand(shape, generator=gen, device=dev) < 0.1] = 0.0
    links = tuple(0.25 * torch.rand(shape, generator=gen, device=dev)
                  for _ in range(3))
    b = torch.randn(shape, generator=gen, device=dev)
    xc = torch.randn(pm.coarse_shape(shape), generator=gen, device=dev)
    return diag, links, b, xc


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", CHUNKS, ids=str)
@pytest.mark.parametrize("shape", LEVEL_SHAPES + RAGGED_SHAPES, ids=str)
def test_vcycle_kernels_equal_their_plain_versions(cuda, shape, chunk,
                                                   monkeypatch):
    """K3 mg_down (x and rc) and K4 mg_up torch.equal to mg_down_ref /
    mg_up_ref, with a bf16 and an f32 operator."""
    if chunk != "auto":
        planes = shape[1] + shape[1] % 2 if chunk == "all" else chunk
        monkeypatch.setattr(pm, "plane_chunk", lambda s, sms: planes)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sum(shape))
    diag, links, b, xc = _level_inputs(shape, gen, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        d, lk = diag.to(dtype), tuple(a.to(dtype) for a in links)
        x, rc = pm.mg_down(d, lk, b, 0.8)
        xr, rcr = pm.mg_down_ref(d, lk, b, 0.8)
        assert torch.equal(x, xr), dtype
        assert torch.equal(rc, rcr), dtype
        up = (d, lk, b, xr, xc, 0.8, 1.4)
        assert torch.equal(pm.mg_up(*up), pm.mg_up_ref(*up)), dtype


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, backend, stored", [
    ("bf16", "auto", torch.bfloat16), ("f32", "auto", torch.float32),
    ("bf16", "xla", torch.float32)])
def test_v_cycle_equals_the_plain_recursion(cuda, dtype, backend, stored):
    """A whole V-cycle of each solve's hierarchy at 32^3 through the kernels
    torch.equal to the recursion through their plain versions; the levels
    stored as mg_operator_dtype says, in f32 under mg_backend "xla"."""
    cfg = SimConfig(isize=32, jsize=32, ksize=32, dx=1.0 / 32,
                    mg_operator_dtype=dtype, mg_backend=backend)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    for shapes in smoke.vcycle_level_shapes(cfg.grid_shape, cfg).values():
        diag, links, b = smoke._random_level(shapes[0], gen, cuda)
        hier = mg.build_hierarchy(diag, links, cfg)
        assert [op[0].dtype for op in hier.ops] == [stored] * len(shapes)
        got = mg.v_cycle(hier, b, 1, 1, cfg.mg_omega, cfg.mg_coarse_scale)
        assert torch.equal(got, v_cycle_plain(
            hier, b, cfg.mg_omega, cfg.mg_coarse_scale))


@pytest.mark.gpu
@pytest.mark.parametrize("n_slabs", [2, 4])
def test_sharded_pallas_step_on_the_card_matches_the_cpu(cuda, n_slabs):
    """One frame of the bench scene at 64^3 in n_slabs slabs on "pallas",
    on the card (K5, K2 and its one-grid form once per slab and substep)
    and on the CPU's plain versions from the same state: equal substeps
    and overflow, iterations within 1, the particle multisets within
    5e-4, the owned rows of u within 5e-4."""
    from flipviscosity3d_torch.core.state import state_from_numpy
    from flipviscosity3d_torch.core.state import state_to_numpy
    from flipviscosity3d_torch.parallel import shard_step as sh
    from flipviscosity3d_torch.parallel.collectives import LocalGroup

    sim = bench_scene("cpu", 64)
    cfg, arrays = sim.cfg, state_to_numpy(sim.state)
    out = {}
    for dev in ("cpu", cuda):
        state = state_from_numpy(arrays, dev)
        spec = sh.make_spec(cfg, n_slabs, n_particles=state.pos.shape[0])
        group = LocalGroup(n_slabs, dev)
        ss = sh.shard_simstate(state, cfg, spec, group)
        _build.reset_launch_counts()
        ss, d = sh.advance_sharded(ss, DT, cfg, spec, group)
        out[torch.device(dev).type] = (ss, d, _build.launch_counts())
    (c_ss, c_d, _), (g_ss, g_d, launches) = out["cpu"], out["cuda"]
    assert g_d.substeps == c_d.substeps
    assert g_d.bucket_overflow == c_d.bucket_overflow
    assert abs(g_d.pressure_iterations - c_d.pressure_iterations) <= 1
    assert abs(g_d.viscosity_iterations - c_d.viscosity_iterations) <= 1
    want = smoke.sharded_launches(smoke.SHARDED_KERNELS, g_d, n_slabs)
    for k, v in launches.items():
        assert v == want[k], k
    g_pos, _ = sh.gather_particles(g_ss)
    c_pos, _ = sh.gather_particles(c_ss)
    assert g_pos.shape == c_pos.shape
    assert abs(torch.tensor(g_pos).sort(0).values
               - torch.tensor(c_pos).sort(0).values).max() <= 5e-4
    assert abs(torch.tensor(sh.gather_grid_u(g_ss, spec))
               - torch.tensor(sh.gather_grid_u(c_ss, spec))).max() <= 5e-4


@pytest.mark.gpu
def test_slab_kernels_match_plain_versions_on_slab_shapes(cuda):
    """K5 and K2 at a slab's local shape (B + 2H = 48 rows of a 64^3 grid
    in 2 slabs), on a stream in random order with dead rows keyed as the
    slab pipeline keys them, so that a pass-A budget of 2 tiles a chunk
    leaves most particles uncovered: K5's sums within rtol 1e-5 of its plain version, table and
    counts equal; K2 with two grids (u cropped to 48 rows and padded back
    with zeros) and with one torch.equal to gather_mac_ref."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    shape, dx = (48, 64, 64), 1.0 / 64
    n = 200_000
    lo = torch.tensor([0.02, 0.02, 0.02], device=cuda)
    hi = torch.tensor([0.98 * 48 / 64, 0.5, 0.98], device=cuda)
    pos = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=cuda)
    vel = torch.randn((n, 3), generator=gen, device=cuda)
    alive = torch.rand(n, generator=gen, device=cuda) > 0.2
    key = torch.where(alive, pp.key_of_position(pos, dx, shape),
                      torch.full((n,), torch.iinfo(torch.int32).max,
                                 dtype=torch.int32, device=cuda))
    plan = pp.plan_pass_a(key, shape, budget=2, factor=1.2)
    covered = int(plan.covered.sum())
    assert 0 < covered < int(alive.sum())
    for terms in (3, 1, 2):
        sums, table, counts = pp.scatter_p2g_table_stale(
            pos, vel, key, plan, shape, dx, 12, terms=terms)
        rs, rt, rc = pp.scatter_p2g_table_stale_ref(
            pos, vel, key, plan.covered, shape, dx, 12, terms=terms)
        scale = float(rs.abs().max())
        assert float((sums - rs).abs().max()) <= 1e-5 * scale, terms
        assert torch.equal(table, rt) and torch.equal(counts, rc), terms
    faces = ((48, 64, 64), (48, 65, 64), (48, 64, 65))
    grids = [[torch.randn(fs, generator=gen, device=cuda) for fs in faces]
             for _ in range(2)]
    for g in grids:
        g[0] = torch.nn.functional.pad(g[0], (0, 0, 0, 0, 0, 1))
    px, py, pz = (pos[:, a].contiguous() for a in range(3))
    for n_grids in (1, 2):
        gs = [[g[c] for g in grids[:n_grids]] for c in range(3)]
        got = pp.gather_mac(px, py, pz, key, *gs, dx, shape)
        want = pp.gather_mac_ref(px, py, pz, key, *gs, dx, shape)
        assert torch.equal(got, want), n_grids


@pytest.mark.gpu
def test_stream_segment_sums_repeat_bit_for_bit(cuda):
    """The stream engine's segment_reduce twice on one 4.1M-row stream of
    the bench pool at 128^3 (54 sums a particle, 512 dead rows keyed
    n_cells): torch.equal sums and mins, each cell's sum equal to a float64
    sum of its run within 1e-5 of its scale, the dead rows in no cell."""
    from flipviscosity3d_torch.ops import stream as tstream

    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    res, n, dead = 128, BENCH_PARTICLES, 512
    shape = (res,) * 3
    n_cells = res ** 3
    lo = torch.tensor([0.02, 0.02, 0.02], device=cuda)
    hi = torch.tensor([0.98, 0.27, 0.98], device=cuda)
    pos = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=cuda)
    key = tstream.cell_of_position(pos, 1.0 / res, shape).to(torch.int64)
    key[-dead:] = n_cells
    stream = tstream.stream_sort_keys(key, [], shape)
    sums = list(torch.randn((54, n), generator=gen, device=cuda).unbind(0))
    mins = list(torch.randn((3, n), generator=gen, device=cuda).unbind(0))
    s1, m1 = tstream.segment_reduce(stream, sums, mins, 0.25)
    s2, m2 = tstream.segment_reduce(stream, sums, mins, 0.25)
    for a, b in zip(s1 + m1, s2 + m2):
        assert torch.equal(a, b)
    want = torch.zeros((n_cells + 1,), dtype=torch.float64, device=cuda)
    want.index_add_(0, stream.key, sums[0].double())
    scale = float(want.abs().max())
    assert float((s1[0].double() - want[:n_cells]).abs().max()) <= 1e-5 * scale
    assert int(stream.counts.sum()) == n - dead

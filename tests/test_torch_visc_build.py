"""K14's wrappers, the viscosity system build, on the CPU: for CPU tensors
compute_volume_grids and build_viscosity_system are their plain versions
and count no launch; both refuse what the kernels do not take; the
identities the volume kernel rests on hold against the plain version;
smoke's records of K14 run on CPU tensors. The kernel itself is held
against the plain version on the card (tests/test_torch_gpu.py)."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from flipviscosity3d_torch import smoke
from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.ops.levelset import volume_fraction_cube
from flipviscosity3d_torch.parallel import shard_step as sh
from flipviscosity3d_torch.solvers import viscosity as vs

DT = 0.004


def _faces(i, j, k):
    return ((i + 1, j, k), (i, j + 1, k), (i, j, k + 1))


def _slab_masks(faces, cfg, rank, spec):
    """The rows' ranges of slab `rank` in the global domain, as
    shard_step's viscosity build makes them."""
    rows = faces[0][0]
    return tuple(
        sh._i_range_mask(rows, 1, cfg.isize, spec, rank, "cpu")
        & sh._jk_range_mask(fs, (1, 1), (cfg.jsize, cfg.ksize), "cpu")
        for fs in faces)


# (liquid phi's shape, face shapes, viscosity's shape, row masks): a cube,
# an odd grid, and the inner slab of a 16^3 grid in 2 slabs (B + 2H = 20
# rows on every component) with its row masks
_SLAB_CFG = SimConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16)
_SLAB_FACES = ((20, 16, 16), (20, 17, 16), (20, 16, 17))
CASES = {
    "cube": ((8, 8, 8), _faces(8, 8, 8), None, None),
    "odd": ((13, 18, 11), _faces(13, 18, 11), None, None),
    "slab": ((20, 16, 16), _SLAB_FACES, (21, 17, 17),
             _slab_masks(_SLAB_FACES, _SLAB_CFG, 1,
                         sh.SlabSpec(n=2, B=8, H=6, cap=0, mig=0))),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(shape):
    return SimConfig(isize=shape[0], jsize=shape[1], ksize=shape[2],
                     dx=1.0 / max(shape))


def _inputs(name, field, seed=14):
    shape, faces, visc_shape, masks = CASES[name]
    gen = torch.Generator()
    gen.manual_seed(seed)
    phi = smoke.visc_build_phi(shape, field, gen, "cpu")
    u, v, w, states, visc = smoke.visc_build_inputs(phi, faces, gen, "cpu",
                                                    visc_shape)
    cfg = _SLAB_CFG if name == "slab" else _cfg(shape)
    return phi, (u, v, w, states, visc), masks, cfg


@pytest.mark.parametrize("field", smoke.VISC_BUILD_FIELDS)
@pytest.mark.parametrize("name", list(CASES))
def test_wrappers_on_cpu_are_the_plain_versions(name, field):
    phi, (u, v, w, states, visc), masks, cfg = _inputs(name, field)
    vols = vs.compute_volume_grids(phi, cfg)
    want = vs.compute_volume_grids_ref(phi, cfg)
    for f in dataclasses.fields(vols):
        assert torch.equal(getattr(vols, f.name), getattr(want, f.name))
    got = smoke.visc_system_grids(vs.build_viscosity_system(
        u, v, w, vols, states, visc, DT, cfg, row_masks=masks))
    ref = smoke.visc_system_grids(vs.build_viscosity_system_ref(
        u, v, w, vols, states, visc, DT, cfg, row_masks=masks))
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert vs.compute_volume_grids.launches == 0
    assert vs.build_viscosity_system.launches == 0


def _refused_volumes(phi):
    return {
        "meta": phi.to("meta"),
        "f64": phi.double(),
        "non-contiguous": phi.transpose(0, 2),
        "not 3-D": phi[None],
    }


@pytest.mark.parametrize("case", ["meta", "f64", "non-contiguous",
                                  "not 3-D"])
def test_volume_grids_refuse_what_the_kernel_does_not_take(case):
    phi, *_ = _inputs("odd", "sphere")
    with pytest.raises(ValueError):
        vs.compute_volume_grids(_refused_volumes(phi)[case], _cfg(phi.shape))


def _refused_system(u, v, w, states, visc, vols, masks):
    """build_viscosity_system's arguments (u, v, w, volumes, states,
    viscosity, row masks), each case with one input the kernel does not
    take."""
    return {
        "meta": (u.to("meta"), v.to("meta"), w.to("meta"), vols,
                 vs.FaceStates(*(s.to("meta") for s in (
                     states.solid_u, states.solid_v, states.solid_w))),
                 visc.to("meta"), masks),
        "f64 velocity": (u.double(), v, w, vols, states, visc, masks),
        "f64 viscosity": (u, v, w, vols, states, visc.double(), masks),
        "float solid": (u, v, w, vols, dataclasses.replace(
            states, solid_v=states.solid_v.float()), visc, masks),
        "non-contiguous volume": (u, v, w, dataclasses.replace(
            vols, edge_u=vols.edge_u.transpose(1, 2).contiguous()
            .transpose(1, 2)), states, visc, masks),
        "solid of another shape": (u, v, w, vols, dataclasses.replace(
            states, solid_w=states.solid_w[:, :, :-1].contiguous()), visc,
            masks),
        "row mask of another shape": (u, v, w, vols, states, visc, (
            masks[0], masks[1][:-1].contiguous(), masks[2])),
        "meta row mask": (u, v, w, vols, states, visc, (
            masks[0].to("meta"), masks[1], masks[2])),
    }


SYSTEM_REFUSALS = ["meta", "f64 velocity", "f64 viscosity", "float solid",
                   "non-contiguous volume", "solid of another shape",
                   "row mask of another shape", "meta row mask"]


@pytest.mark.parametrize("case", SYSTEM_REFUSALS)
def test_build_refuses_what_the_kernel_does_not_take(case):
    phi, (u, v, w, states, visc), masks, cfg = _inputs("slab", "pool")
    vols = vs.compute_volume_grids(phi, cfg)
    *args, row_masks = _refused_system(u, v, w, states, visc, vols,
                                       masks)[case]
    with pytest.raises(ValueError):
        vs.build_viscosity_system(*args, DT, cfg, row_masks=row_masks)


def _volume_kernel_emulated(phi):
    """What K14's volume kernel computes at each node, written out in
    torch: the mask as phi < 0 within an L1 ball of radius 2 (out of range
    reads 0), the corner samples of each grid from phi at node offsets in
    [-1, 1] (the lower averaged axis first), the cube's fraction, 0 where
    the mask is unset; checks the fast paths' claims on the way (a cube
    whose corners share a sign is exactly 1 or 0, and a node whose 3x3x3
    block of phi is <= 0, or > 0, has such corners on every grid)."""
    ni, nj, nk = (n + 1 for n in phi.shape)
    padded = F.pad(phi, (3,) * 6)

    def at(di, dj, dk):
        return padded[3 + di:3 + di + ni, 3 + dj:3 + dj + nj,
                      3 + dk:3 + dk + nk]

    mask = torch.zeros((ni, nj, nk), dtype=torch.bool)
    le = torch.ones_like(mask)    # phi <= 0 on the node's 3x3x3 block
    gt = torch.ones_like(mask)    # phi > 0 there
    for di in range(-2, 3):
        for dj in range(-2, 3):
            for dk in range(-2, 3):
                if abs(di) + abs(dj) + abs(dk) <= 2:
                    mask |= at(di, dj, dk) < 0
                if max(abs(di), abs(dj), abs(dk)) <= 1:
                    le &= at(di, dj, dk) <= 0
                    gt &= at(di, dj, dk) > 0
    out = {}
    for name, (ai, aj, ak) in vs._VOLUME_AXES:
        lo = (ai, 0 if ai else aj, 0)          # the lower averaged axis
        hi = (0, aj if ai else 0, ak)          # the higher
        corners = []
        for b in range(8):
            c = (b & 1, (b >> 1) & 1, b >> 2)
            if ai + aj + ak == 0:
                val = at(*c)
            elif ai + aj + ak == 1:
                val = 0.5 * (at(*(x - a for x, a in zip(c, (ai, aj, ak))))
                             + at(*c))
            else:
                val = 0.5 * (
                    0.5 * (at(*(x - p - q for x, p, q in zip(c, lo, hi)))
                           + at(*(x - q for x, q in zip(c, hi))))
                    + 0.5 * (at(*(x - p for x, p in zip(c, lo))) + at(*c)))
            corners.append(val)
        frac = volume_fraction_cube(*corners)
        inside = torch.stack([c <= 0 for c in corners]).all(dim=0)
        outside = torch.stack([c > 0 for c in corners]).all(dim=0)
        assert torch.equal(frac[inside], torch.ones_like(frac[inside]))
        assert torch.equal(frac[outside], torch.zeros_like(frac[outside]))
        assert bool((inside | ~le).all()) and bool((outside | ~gt).all())
        frac = torch.where(mask, frac, torch.zeros_like(frac))
        out[name] = frac[:phi.shape[0] + ai, :phi.shape[1] + aj,
                         :phi.shape[2] + ak]
    return out


@pytest.mark.parametrize("field", smoke.VISC_BUILD_FIELDS)
def test_volume_kernel_identities_hold(field):
    """The volume kernel's node-local form (_volume_kernel_emulated) equals
    compute_volume_grids_ref: two 6-neighbour dilations are the L1 ball of
    radius 2, the nested pads are phi read as 0 out of range, and the fast
    paths give the full sum's values."""
    for name in ("cube", "odd", "slab"):
        phi, *_ = _inputs(name, field)
        want = vs.compute_volume_grids_ref(phi, None)
        for key, got in _volume_kernel_emulated(phi).items():
            assert torch.equal(got, getattr(want, key)), (name, key)


def test_build_records_run_on_cpu():
    """smoke's K14 records, which chip_smoke.py runs on the card at 128^3
    and 256^3, at 16^3 on CPU tensors: every check equal, each bound the
    bytes of its inputs and outputs."""
    cfg = SimConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16)
    gen = torch.Generator()
    gen.manual_seed(0)
    records = smoke._visc_build_records(cfg, torch.device("cpu"), gen)
    assert list(records) == ["compute_volume_grids", "build_viscosity_system"]
    checks, times, bnd = records["compute_volume_grids"]
    assert [c["check"].split(" ")[0] for c in checks] == [
        name for name, _ in vs._VOLUME_AXES]
    grid_cells = sum(17 ** sum(a) * 16 ** (3 - sum(a))
                     for _, a in vs._VOLUME_AXES)
    assert bnd["bytes"] == 4 * (16 ** 3 + grid_cells)
    checks_s, times_s, bnd_s = records["build_viscosity_system"]
    assert [c["check"] for c in checks_s] == ["in_mat", "diag", "vol",
                                              "factors", "rhs"]
    faces = 3 * 17 * 16 * 16      # the three components' faces
    # read: velocities, solid masks, the volume grids and the viscosity;
    # written: in_mat, diag, vol, 18 factors and rhs
    assert bnd_s["bytes"] == (4 * faces + faces + 4 * grid_cells
                              + 4 * 17 ** 3 + faces + 4 * 9 * faces)
    for c in checks + checks_s:
        assert c["ok"], c
    for t in (times, times_s):
        assert t["ms"] > 0 and t["ms_cold"] is None
    assert bnd["bound_by"] == bnd_s["bound_by"] == "bytes"

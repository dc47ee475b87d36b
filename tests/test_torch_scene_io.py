"""The port's IO (``mantaflow_tpu_torch/io``, ``scene/io_api.py``) against
the JAX package's.

Each package writes into its own directory (``j/``, ``t/``) under the same
file names: a gzip header carries the file's name.

The files each package writes are equal byte for byte (the ``.uni`` and
``.bobj.gz`` headers stamp ``time.time()``, pinned here), each package
reads the other's, and a state checkpoint written by either package loads
into the other's state as equal values.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import mantaflow_tpu as J
import mantaflow_tpu_torch as T
from mantaflow_tpu.io import png as jpng
from mantaflow_tpu.io import uni as juni
from mantaflow_tpu.io import vdb as jvdb
from mantaflow_tpu_torch.io import png as tpng
from mantaflow_tpu_torch.io import uni as tuni
from mantaflow_tpu_torch.io import vdb as tvdb

F32 = np.float32


@pytest.fixture(autouse=True)
def _pinned_time(monkeypatch, tmp_path):
    import time
    monkeypatch.setattr(time, "time", lambda: 1700000000.0)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arr(x):
    x = x.data if hasattr(x, "data") else x
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def grids(m, seed=0):
    s = m.Solver(name="s", gridSize=m.vec3(12, 10, 8), dim=3,
                 **({"device": "cpu"} if m is T else {}))
    rng = np.random.default_rng(seed)
    out = {}
    for k, c, sh in (("flags", m.FlagGrid, None), ("real", m.RealGrid, ()),
                     ("ls", m.LevelsetGrid, ()), ("int", m.IntGrid, ()),
                     ("vec", m.Vec3Grid, (3,)), ("mac", m.MACGrid, (3,))):
        g = s.create(c, name=k)
        if c is m.FlagGrid:
            g.initDomain(boundaryWidth=1)
        elif c is m.IntGrid:
            g.from_numpy(rng.integers(-5, 50, (8, 10, 12)).astype(np.int32))
        else:
            g.from_numpy(rng.uniform(-1, 1, sh + (8, 10, 12)).astype(F32))
        out[k] = g
    return s, out


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("ext", ["uni", "raw", "npz", "txt", "vol", "vdb"])
def test_grid_files_equal_and_cross_read(ext):
    _, jg = grids(J)
    _, tg = grids(T)
    for k in jg:
        if ext in ("txt", "vol") and k in ("vec", "mac", "int", "flags"):
            continue
        jg[k].save(f"j/{k}.{ext}")
        tg[k].save(f"t/{k}.{ext}")
        assert read(f"j/{k}.{ext}") == read(f"t/{k}.{ext}"), k
        if ext == "txt":
            continue
        # each package reads the other's file
        _, jb = grids(J, seed=1)
        _, tb = grids(T, seed=1)
        jb[k].load(f"t/{k}.{ext}")
        tb[k].load(f"j/{k}.{ext}")
        np.testing.assert_array_equal(arr(jb[k]), arr(tg[k]), err_msg=k)
        np.testing.assert_array_equal(arr(tb[k]), arr(jg[k]), err_msg=k)


def test_batched_save_load():
    _, jg = grids(J)
    _, tg = grids(T)
    J.save("j/b.uni", [jg["real"], jg["mac"]])
    T.save("t/b.uni", [tg["real"], tg["mac"]])
    for i in (0, 1):
        assert read(f"j/b_{i}.uni") == read(f"t/b_{i}.uni")
    _, tb = grids(T, seed=2)
    T.load("j/b.uni", [tb["real"], tb["mac"]])
    np.testing.assert_array_equal(arr(tb["real"]), arr(jg["real"]))
    np.testing.assert_array_equal(arr(tb["mac"]), arr(jg["mac"]))


def particles(m):
    s = m.Solver(name="s", gridSize=m.vec3(16, 16, 16), dim=3,
                 **({"device": "cpu"} if m is T else {}))
    f = s.create(m.FlagGrid)
    f.initDomain(boundaryWidth=1)
    phi = s.create(m.LevelsetGrid)
    phi.from_numpy(np.fromfunction(lambda z, y, x: y - 6.0, (16, 16, 16),
                                   dtype=F32))
    f.updateFromLevelset(phi)
    pp = s.create(m.BasicParticleSystem)
    pv, pr, pi = pp.create(m.PdataVec3), pp.create(m.PdataReal), \
        pp.create(m.PdataInt)
    m.sampleLevelsetWithParticles(phi=phi, flags=f, parts=pp,
                                  discretization=2, randomness=0.1)
    n = pp.pySize()
    rng = np.random.default_rng(3)
    for pd, a in ((pv, rng.uniform(-1, 1, (n, 3))),
                  (pr, rng.uniform(0, 1, n)), (pi, rng.integers(0, 9, n))):
        m.copyArrayToPdataReal(a.astype(np.int32 if pd is pi else F32), pd)
    return s, pp, (pv, pr, pi)


@pytest.mark.parametrize("ext", ["uni", "npz"])
def test_particle_files_equal_and_cross_read(ext):
    _, jp, jd = particles(J)
    _, tp, td = particles(T)
    jp.save(f"j/parts.{ext}")
    tp.save(f"t/parts.{ext}")
    assert read(f"j/parts.{ext}") == read(f"t/parts.{ext}")
    for i, (a, b) in enumerate(zip(jd, td)):
        a.save(f"j/pd{i}.{ext}")
        b.save(f"t/pd{i}.{ext}")
        assert read(f"j/pd{i}.{ext}") == read(f"t/pd{i}.{ext}"), i
    _, tq, tqd = particles(T)
    tq.load(f"j/parts.{ext}")
    n = jp.pySize()
    assert tq.pySize() == n
    np.testing.assert_array_equal(arr(tq.parts.pos)[:n],
                                  np.asarray(jp.parts.pos)[:n])
    np.testing.assert_array_equal(arr(tq.parts.flags)[:n],
                                  np.asarray(jp.parts.flags)[:n])
    for i, b in enumerate(tqd):
        b.load(f"j/pd{i}.{ext}")
        np.testing.assert_array_equal(arr(b)[:n], np.asarray(jd[i].data)[:n])
    _, jq, jqd = particles(J)
    jq.load(f"t/parts.{ext}")
    np.testing.assert_array_equal(np.asarray(jq.parts.pos)[:n],
                                  arr(tp.parts.pos)[:n])
    jp.save("j/parts.txt")
    tp.save("t/parts.txt")
    assert read("j/parts.txt") == read("t/parts.txt")


def test_mesh_files_equal_and_cross_read():
    out = {}
    for m, tag in ((J, "j"), (T, "t")):
        s = m.Solver(name="s", gridSize=m.vec3(16, 16, 16), dim=3,
                     **({"device": "cpu"} if m is T else {}))
        phi = s.create(m.LevelsetGrid)
        phi.from_numpy(np.fromfunction(
            lambda z, y, x: np.sqrt((x - 8) ** 2 + (y - 7) ** 2
                                    + (z - 8) ** 2) - 5, (16, 16, 16),
            dtype=F32))
        mesh = s.create(m.Mesh)
        phi.createMesh(mesh)
        for ext in ("obj", "bobj.gz"):
            mesh.save(f"{tag}/x.{ext}")
        md = mesh.create(importlib.import_module(
            m.__name__ + ".scene.mesh_api").MdataReal)
        md.setConst(0.5)
        md.save(f"{tag}/md.uni")
        out[tag] = (s, m, mesh)
    for name in ("{}/x.obj", "{}/x.bobj.gz", "{}/md.uni"):
        assert read(name.format("j")) == read(name.format("t")), name
    for src, dst in (("j", "t"), ("t", "j")):
        s, m, mesh = out[dst]
        back = s.create(m.Mesh)
        back.load(f"{src}/x.bobj.gz")
        ref = out[src][2]
        np.testing.assert_allclose(back.nodes, ref.nodes, atol=2e-5)
        np.testing.assert_array_equal(back.tris, ref.tris)


def test_uni_png_vdb_modules_write_equal_bytes():
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (6, 7, 8)).astype(F32)
    v = rng.uniform(-1, 1, (3, 6, 7, 8)).astype(F32)
    for mod, tag in ((juni, "j"), (tuni, "t")):
        mod.write_grid_uni(f"{tag}/a.uni", a, mod.TypeReal)
        mod.write_grid_uni(f"{tag}/v.uni", v, mod.TypeVec3 | mod.TypeMAC)
        mod.write_particles_uni(f"{tag}/p.uni", v[:, 0, 0].T.copy(),
                                np.arange(8, dtype=np.int32), (8, 7, 6))
        mod.write_pdata_uni(f"{tag}/d.uni", a[0, 0], (8, 7, 6))
    for k in ("a", "v", "p", "d"):
        assert read(f"j/{k}.uni") == read(f"t/{k}.uni"), k
        np.testing.assert_array_equal(
            np.asarray(tuni.read_grid_uni(f"j/{k}.uni")[0]) if k in "av"
            else np.asarray(tuni.read_pdata_uni(f"j/{k}.uni")[0])
            if k == "d" else tuni.read_particles_uni(f"j/{k}.uni")[0],
            np.asarray(juni.read_grid_uni(f"t/{k}.uni")[0]) if k in "av"
            else np.asarray(juni.read_pdata_uni(f"t/{k}.uni")[0])
            if k == "d" else juni.read_particles_uni(f"t/{k}.uni")[0])
    img = (rng.uniform(0, 1, (9, 11, 3)) * 255).astype(np.uint8)
    jpng.write_png("j/x.png", img)
    tpng.write_png("t/x.png", img)
    assert read("j/x.png") == read("t/x.png")
    grids_ = [{"name": "density", "data": a, "grid_class": jvdb.CLASS_FOG},
              {"name": "vel", "data": v, "grid_class": jvdb.CLASS_STAGGERED}]
    jvdb.write_vdb("j/x.vdb", grids_)
    tvdb.write_vdb("t/x.vdb", grids_)
    assert read("j/x.vdb") == read("t/x.vdb")
    for got, ref in zip(tvdb.read_vdb("j/x.vdb"), jvdb.read_vdb("t/x.vdb")):
        np.testing.assert_array_equal(got["data"], ref["data"])


def test_project_ppm_full_equal_bytes():
    for m, tag in ((J, "j"), (T, "t")):
        _, g = grids(m)
        m.projectPpmFull(g["real"], f"{tag}/x.ppm", 0, 2.0)
        m.projectPpmFull(g["real"], f"{tag}/x.png", 0, 1.5)
        gui = m.Gui()
        gui.screenshot(f"{tag}/shot.ppm", grid=g["real"])
    for ext in ("ppm", "png"):
        assert read(f"j/x.{ext}") == read(f"t/x.{ext}")
    assert read("j/shot.ppm") == read("t/shot.ppm")


def _smoke_states():
    from mantaflow_tpu.core.domain import Domain as JDomain
    from mantaflow_tpu.core.shapes import Sphere as JSphere
    from mantaflow_tpu.models import smoke as jsmoke
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Sphere
    from mantaflow_tpu_torch.models import smoke as tsmoke
    kw = dict(buoyancy=(0.0, -6e-4, 0.0), vorticity_confinement=0.1,
              adaptive_dt=True, cfl=3.0, dt_max=2.0)
    size = (16, 16, 16)
    jst = jsmoke.make_smoke_state(JDomain(size=size), jsmoke.SmokeParams(
        **kw), source_shape=JSphere(center=(8, 2, 8), radius=3))
    jst = jsmoke.smoke_step(jst, JDomain(size=size), jsmoke.SmokeParams(
        **kw))
    tst = tsmoke.make_smoke_state(Domain(size=size), tsmoke.SmokeParams(
        **kw), source_shape=Sphere(center=(8, 2, 8), radius=3), device="cpu")
    return jst, tst


def _flip_states():
    from mantaflow_tpu.core.domain import Domain as JDomain
    from mantaflow_tpu.models import flip as jflip
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.models import flip as tflip
    size = (16, 16, 16)
    jst = jflip.make_dam_state(JDomain(size=size), jflip.FlipParams())
    tst = tflip.make_dam_state(Domain(size=size), tflip.FlipParams(),
                               device="cpu")
    tst = tflip.flip_step(tst, Domain(size=size), tflip.FlipParams())
    return jst, tst


def _leaves(state):
    """A state's leaves in pytree order, as numpy arrays."""
    if isinstance(state.flags, torch.Tensor):
        from mantaflow_tpu_torch.scene import io_api
        return [arr(x) for x in io_api._flatten(state)]
    import jax
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


@pytest.mark.parametrize("kind", ["smoke", "flip"])
def test_checkpoints_cross_load(kind):
    jst, tst = _smoke_states() if kind == "smoke" else _flip_states()
    # JAX -> port: the JAX package's (stepped) state into the port's
    J.save_checkpoint("j/c.npz", jst)
    got = T.load_checkpoint("j/c.npz", tst)
    ref = _leaves(jst)
    mine = _leaves(got)
    assert len(ref) == len(mine)
    for a, b in zip(ref, mine):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got.flags.device.type == "cpu"
    # port -> JAX
    T.save_checkpoint("t/c.npz", tst)
    back = J.load_checkpoint("t/c.npz", jst)
    for a, b in zip(_leaves(back), _leaves(tst)):
        np.testing.assert_array_equal(a, b)
    assert os.path.getsize("t/c.npz") > 0

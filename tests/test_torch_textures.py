"""Textures, the mip atlas and its lookups, and ray differentials: the port
against pbrt_tpu on the same inputs, made with numpy from a seed.

Tolerances: the texture tables and the atlas (Lanczos resampling included)
bit-equal; eval_texture within 1e-6 absolute, 1e-5 for the Perlin kinds
(fbm, wrinkled, windy, marble: the hashes are bit-equal, XLA contracts the
fade polynomials into FMAs); the atlas lookups within 1e-6; camera ray
differentials and the uv derivatives within rtol 1e-5 / atol 1e-5 (1e-4
for derivatives, which divide by a 2x2 determinant)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import jax_bench_scene, lanes

from pbrt_tpu.core.interaction import (SurfaceInteraction as JSI, compute_differentials as
                                       j_compute_differentials, specular_diff_rays as
                                       j_specular_diff_rays)
from pbrt_tpu.core.ray import Rays as JRays
from pbrt_tpu.integrators.common import camera_rays as j_camera_rays
from pbrt_tpu.scene import load_scene_string as j_load_scene_string
from pbrt_tpu.textures import eval_texture as j_eval_texture
from pbrt_tpu.textures.image import (sample_atlas as j_sample_atlas, sample_atlas_aniso as
                                     j_sample_atlas_aniso, sample_atlas_trilinear as
                                     j_sample_atlas_trilinear)
from pbrt_tpu_torch import materials, textures
from pbrt_tpu_torch.core.interaction import (SurfaceInteraction, compute_differentials,
                                             make_frame, specular_diff_rays)
from pbrt_tpu_torch.core.ray import Rays
from pbrt_tpu_torch.integrators import path
from pbrt_tpu_torch.integrators.common import camera_rays
from pbrt_tpu_torch.io.image_io import write_pfm, write_png
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.bench import build_bench_scene
from pbrt_tpu_torch.scene.build import reachable_kinds
from pbrt_tpu_torch.scene import intersect as I
from pbrt_tpu_torch.textures import eval_texture
from pbrt_tpu_torch.textures.image import (build_atlas, lanczos_resize, sample_atlas,
                                           sample_atlas_aniso, sample_atlas_trilinear)

TEXTURES = '''
Texture "c" "color" "constant" "rgb value" [0.2 0.4 0.6]
Texture "f" "float" "constant" "float value" 0.5
Texture "ck" "color" "checkerboard" "rgb tex1" [0.9 0.1 0.1] "rgb tex2" [0.1 0.1 0.9]
  "float uscale" 4 "float vscale" 3
Texture "sc" "color" "scale" "texture tex1" "ck" "texture tex2" "c"
Texture "mx" "color" "mix" "texture tex1" "sc" "rgb tex2" [0 1 0] "float amount" 0.3
Texture "bl" "color" "bilerp" "rgb v00" [1 0 0] "rgb v01" [0 1 0] "rgb v10" [0 0 1]
  "rgb v11" [1 1 1]
Texture "uvt" "color" "uv" "string mapping" "spherical"
Texture "ck3" "color" "checkerboard" "integer dimension" 3 "rgb tex1" [1 1 1] "rgb tex2" [0 0 0]
Texture "dt" "color" "dots" "rgb inside" [1 0.5 0] "rgb outside" [0 0.2 0.2]
  "float uscale" 5 "float vscale" 5 "string mapping" "cylindrical"
Texture "fb" "float" "fbm"
Texture "wr" "float" "wrinkled"
Texture "wi" "float" "windy"
Texture "ma" "color" "marble" "float scale" 2 "float variation" 0.5
Texture "im" "color" "imagemap" "string filename" "a.png" "float uscale" 2 "float vscale" 3
Texture "ip" "color" "imagemap" "string filename" "b.pfm" "string mapping" "planar"
  "vector v1" [1 0 0] "vector v2" [0 0 1]
'''
NAMES = ["c", "f", "ck", "sc", "mx", "bl", "uvt", "ck3", "dt", "fb", "wr", "wi", "ma", "im", "ip"]
NOISE = {"fb", "wr", "wi", "ma"}
CHECKER = 'Texture "ck" "color" "checkerboard" "float uscale" 4 "float vscale" 3\n'
SCENE = '''LookAt 0 4 4  0 0 0  0 1 0
Camera "perspective" "float fov" 35
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "02sequence" "integer pixelsamples" 1
WorldBegin
LightSource "point" "point from" [2 5 1] "rgb I" [40 40 40]
AttributeBegin
  Translate 0.3 0 0
  Rotate 30 0 1 0
{TEX}
  Material "matte" "texture Kd" "{KD}"
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 0 -1  1 0 -1  1 0 1]
AttributeEnd
WorldEnd
'''
TEX_KEYS = ("kind", "params", "child", "w2t", "image_id", "atlas", "atlas_size", "atlas_levels")


@pytest.fixture(scope="module")
def tex_scenes(tmp_path_factory):
    """The scene of every texture kind in both packages; a.png is 24x40
    (resampled to 64x64 for the atlas), b.pfm 16x16."""
    d = tmp_path_factory.mktemp("tex")
    rng = np.random.default_rng(0)
    write_png(str(d / "a.png"), rng.uniform(0, 1, (40, 24, 3)).astype(np.float32))
    write_pfm(str(d / "b.pfm"), rng.uniform(0, 2, (16, 16, 3)).astype(np.float32))
    text = SCENE.replace("{TEX}", TEXTURES).replace("{KD}", "mx")
    return j_load_scene_string(text, cwd=str(d)), load_scene_string(text, device="cpu",
                                                                     cwd=str(d))


def _hits(n, seed):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2, 3, (n, 2)).astype(np.float32)
    p = (3 * rng.normal(size=(n, 3))).astype(np.float32)
    duv = (0.05 * rng.normal(size=(4, n))).astype(np.float32)
    duv[:, ::5] = 0.0
    return uv, p, duv


def test_texture_table_matches_reference(tex_scenes):
    jcs, cs = tex_scenes
    for k in TEX_KEYS:
        assert np.array_equal(getattr(cs.data.tex, k).numpy(), np.asarray(getattr(jcs.data.tex, k))), k
    assert np.array_equal(cs.data.mats.tex.numpy(), np.asarray(jcs.data.mats.tex))
    assert cs.flags.tex_kinds == jcs.flags.tex_kinds == tuple(range(13))
    assert cs.flags.has_tex_slot == jcs.flags.has_tex_slot


@pytest.mark.parametrize("name", NAMES)
def test_eval_texture_matches_reference(tex_scenes, name):
    """Each texture, gated to the kinds it reaches (the gate a scene of it
    alone would set), with and without uv derivatives."""
    jcs, cs = tex_scenes
    n = 2048
    uv, p, duv = _hits(n, seed=NAMES.index(name))
    tid = np.full(n, NAMES.index(name), np.int32)
    tid[::17] = -1
    kinds = reachable_kinds(cs.data.tex.kind.numpy(), cs.data.tex.child.numpy(),
                            [NAMES.index(name)])
    for with_duv in (False, True):
        got = eval_texture(cs.data.tex, torch.as_tensor(tid), torch.as_tensor(uv),
                           torch.as_tensor(p), kinds=kinds,
                           duv=tuple(torch.as_tensor(x) for x in duv) if with_duv else None)
        want = j_eval_texture(jcs.data.tex, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(p),
                              kinds=kinds,
                              duv=tuple(jnp.asarray(x) for x in duv) if with_duv else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 if name in NOISE else 1e-6)
    assert np.all(got.numpy()[::17] == 0.0)


def test_lanczos_resize_is_pils():
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(3)
    for h, w, H, W in ((40, 24, 64, 64), (5, 7, 8, 8), (33, 100, 128, 128)):
        ch = rng.uniform(0, 1, (h, w)).astype(np.float32)
        want = np.asarray(Image.fromarray(ch, mode="F").resize((W, H), Image.LANCZOS),
                          np.float32)
        assert np.array_equal(lanczos_resize(ch, W, H), want), (h, w)


def test_atlas_lookups_match_reference(tex_scenes):
    """Level-0 bilinear, trilinear over widths from 1e-4 to 2 and EWA over
    seeded footprints (some degenerate, some past the eccentricity clamp)."""
    jcs, cs = tex_scenes
    n = 2048
    rng = np.random.default_rng(5)
    tid = np.where(rng.uniform(size=n) < 0.5, NAMES.index("im"), NAMES.index("ip")).astype(np.int32)
    st = rng.uniform(-1, 2, (n, 2)).astype(np.float32)
    width = np.exp(rng.uniform(np.log(1e-4), np.log(2.0), n)).astype(np.float32)
    dst0 = (rng.normal(size=(n, 2)) * 0.05).astype(np.float32)
    dst1 = (rng.normal(size=(n, 2)) * 0.01).astype(np.float32)
    dst1[::7] = 0.0
    dst0[::11] = 0.0
    T, J = cs.data.tex, jcs.data.tex
    t = lambda a: torch.as_tensor(a)
    pairs = [(sample_atlas(T, t(tid), t(st)), j_sample_atlas(J, jnp.asarray(tid), jnp.asarray(st))),
             (sample_atlas_trilinear(T, t(tid), t(st), t(width)),
              j_sample_atlas_trilinear(J, jnp.asarray(tid), jnp.asarray(st), jnp.asarray(width))),
             (sample_atlas_aniso(T, t(tid), t(st), t(dst0), t(dst1)),
              j_sample_atlas_aniso(J, jnp.asarray(tid), jnp.asarray(st), jnp.asarray(dst0),
                                   jnp.asarray(dst1)))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_atlas_of_a_square_power_of_two_is_its_mip_pyramid():
    rng = np.random.default_rng(6)
    im = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    atlas, sizes, nlev = build_atlas([im, np.ones((2, 2, 3), np.float32)])
    assert atlas.shape == (2, 8, 12, 3) and list(nlev) == [4, 2] and sizes[1, 0] == 2
    assert np.array_equal(atlas[0, :8, :8], im)
    l1 = 0.25 * (im[0::2, 0::2] + im[1::2, 0::2] + im[0::2, 1::2] + im[1::2, 1::2])
    assert np.array_equal(atlas[0, 0:4, 8:12], l1)
    assert np.allclose(atlas[0, 6, 8], im.mean((0, 1)), atol=1e-6)   # the 1x1 level


def _si(p, n, dpdu, dpdv):
    N = p.shape[0]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    ss, ts = make_frame(t(n), t(dpdu))
    return SurfaceInteraction(
        valid=torch.ones(N, dtype=torch.bool), t=torch.ones(N), p=t(p), p_err=torch.zeros(N, 3),
        wo=t(n), ng=t(n), ns=t(n), ss=ss, ts=ts, uv=torch.zeros(N, 2), dpdu=t(dpdu),
        dpdv=t(dpdv), prim=torch.zeros(N, dtype=torch.int32),
        material=torch.zeros(N, dtype=torch.int32), area_light=torch.full((N,), -1))


def _plane_rays(p):
    """Rays straight down onto the z = 0 plane at p, their x and y
    neighbours 0.1 and 0.05 over."""
    N = p.shape[0]
    o = p + np.array([0, 0, 1.0], np.float32)
    d = np.tile([0, 0, -1.0], (N, 1)).astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return Rays(t(o), t(d), t(o + [0.1, 0, 0]), t(d), t(o + [0, 0.05, 0]), t(d))


def test_compute_differentials_plane():
    """u = x / 2 on the z = 0 plane: dudx = 0.1 / 2, dvdy = 0.05."""
    N = 8
    p = np.zeros((N, 3), np.float32)
    p[:, 0] = np.linspace(-1, 1, N)
    nz = np.tile([0, 0, 1.0], (N, 1))
    si = compute_differentials(_si(p, nz, np.tile([2.0, 0, 0], (N, 1)),
                                   np.tile([0, 1.0, 0], (N, 1))), _plane_rays(p))
    assert np.allclose(si.dudx.numpy(), 0.05, atol=1e-5)
    assert np.allclose(si.dvdy.numpy(), 0.05, atol=1e-5)
    assert np.allclose(si.dvdx.numpy(), 0.0, atol=1e-6)


def test_specular_diff_rays_mirror_passthrough():
    """A flat mirror at normal incidence keeps the auxiliary rays' spacing;
    lanes that did not scatter specularly get zero auxiliary directions."""
    N = 8
    p = np.zeros((N, 3), np.float32)
    p[:, 0] = np.linspace(-1, 1, N)
    nz = np.tile([0, 0, 1.0], (N, 1))
    si = _si(p, nz, np.tile([1.0, 0, 0], (N, 1)), np.tile([0, 1.0, 0], (N, 1)))
    wi = torch.as_tensor(nz, dtype=torch.float32)
    out = specular_diff_rays(si, _plane_rays(p), wi, torch.ones(N, dtype=torch.bool),
                             torch.zeros(N, dtype=torch.bool), torch.full((N,), 1.5))
    assert np.allclose((out.rx_o - out.o).numpy(), [0.1, 0, 0], atol=1e-5)
    assert np.allclose((out.ry_o - out.o).numpy(), [0, 0.05, 0], atol=1e-5)
    assert np.allclose(out.rx_d.numpy(), [0, 0, 1.0], atol=1e-5)
    out2 = specular_diff_rays(si, _plane_rays(p), wi, torch.zeros(N, dtype=torch.bool),
                              torch.zeros(N, dtype=torch.bool), torch.full((N,), 1.5))
    assert np.allclose(out2.rx_d.numpy(), 0.0)


def _random_frames(n, seed):
    rng = np.random.default_rng(seed)
    ng = rng.normal(size=(n, 3))
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    p = rng.uniform(-2, 2, (n, 3))
    dpdu = rng.normal(size=(n, 3))
    dpdv = np.cross(ng, dpdu) * rng.uniform(0.2, 2, (n, 1))
    dpdu[::13] = 0.0   # degenerate
    o = p + 3 * rng.normal(size=(n, 3))
    d = (p - o) / np.linalg.norm(p - o, axis=1, keepdims=True)
    f = lambda a: np.asarray(a, np.float32)
    return f(p), f(ng), f(dpdu), f(dpdv), f(o), f(d), rng


def test_differentials_match_reference():
    """compute_differentials and specular_diff_rays (reflection and
    transmission lanes) on seeded frames and auxiliary rays."""
    n = 1024
    p, ng, dpdu, dpdv, o, d, rng = _random_frames(n, seed=8)
    rxo = (o + 0.05 * rng.normal(size=(n, 3))).astype(np.float32)
    ryo = (o + 0.05 * rng.normal(size=(n, 3))).astype(np.float32)
    rxd = (d + 0.02 * rng.normal(size=(n, 3))).astype(np.float32)
    ryd = (d + 0.02 * rng.normal(size=(n, 3))).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    spec, trans = rng.uniform(size=n) < 0.7, rng.uniform(size=n) < 0.4
    eta = rng.uniform(1.1, 2.0, n).astype(np.float32)
    si = _si(p, ng, dpdu, dpdv)
    si.valid = torch.as_tensor(valid)
    si.wo = torch.as_tensor(-d)
    ss, ts = make_frame(torch.as_tensor(ng), torch.as_tensor(dpdu))
    z = jnp.zeros(n)
    jsi = JSI(valid=jnp.asarray(valid), t=jnp.ones(n), p=jnp.asarray(p), p_err=jnp.zeros((n, 3)),
              wo=jnp.asarray(-d), ng=jnp.asarray(ng), ns=jnp.asarray(ng),
              ss=jnp.asarray(ss.numpy()), ts=jnp.asarray(ts.numpy()), uv=jnp.zeros((n, 2)),
              dpdu=jnp.asarray(dpdu), dpdv=jnp.asarray(dpdv), prim=jnp.zeros(n, jnp.int32),
              material=jnp.zeros(n, jnp.int32), area_light=jnp.full(n, -1, jnp.int32),
              dudx=z, dvdx=z, dudy=z, dvdy=z)
    t = torch.as_tensor
    rays = Rays(t(o), t(d), t(rxo), t(rxd), t(ryo), t(ryd))
    jrays = JRays.make(jnp.asarray(o), jnp.asarray(d))._replace(
        rx_o=jnp.asarray(rxo), rx_d=jnp.asarray(rxd), ry_o=jnp.asarray(ryo), ry_d=jnp.asarray(ryd))
    got, want = compute_differentials(si, rays), j_compute_differentials(jsi, jrays)
    for k in ("dudx", "dvdx", "dudy", "dvdy"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-4, atol=1e-4)
    assert np.all(got.dudx.numpy()[~valid] == 0.0)
    got = specular_diff_rays(si, rays, t(wi), t(spec), t(trans), t(eta))
    want = j_specular_diff_rays(jsi, jrays, jnp.asarray(wi), jnp.asarray(spec),
                                jnp.asarray(trans), jnp.asarray(eta))
    for k in ("o", "d", "rx_o", "rx_d", "ry_o", "ry_d"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-5)


def test_camera_ray_differentials_match_reference():
    """camera_rays with differentials scaled for 4 spp on the bench
    scene's camera: origins, directions and both auxiliary rays."""
    jcpu, jcs = jax_bench_scene(large=False)
    cs = build_bench_scene(large=False, device="cpu")
    px, py, s = lanes(2048, 64, 4, seed=9)
    rays, _, _ = camera_rays(cs, *(torch.as_tensor(a) for a in (px, py, s)), spp_for_diff=4)
    jrays, _, _ = j_camera_rays(jcpu, jnp.asarray(px), jnp.asarray(py), jnp.asarray(s),
                                spp_for_diff=4)
    for k in ("o", "d", "rx_o", "rx_d", "ry_o", "ry_d"):
        np.testing.assert_allclose(getattr(rays, k).numpy(), np.asarray(getattr(jrays, k)),
                                   rtol=1e-5, atol=1e-5)
    assert not camera_rays(cs, *(torch.as_tensor(a) for a in (px, py, s)))[0].has_differentials


def test_scene_without_textures_issues_no_texture_op(monkeypatch):
    """li_path on the bench scene (no texture, no alpha mask) reaches no
    texture evaluation, no differential and no alpha round; a scene with
    one checkerboard reaches the checkerboard alone."""
    def boom(*a, **k):
        raise AssertionError("texture code ran")
    for mod, name in ((materials, "eval_texture"), (I, "eval_texture"),
                      (path, "compute_differentials"), (path, "specular_diff_rays"),
                      (I, "_alpha_of_hit")):
        monkeypatch.setattr(mod, name, boom)
    cs = build_bench_scene(large=False, device="cpu")
    assert cs.flags.tex_kinds == () and not any(cs.flags.has_tex_slot) and not cs.flags.has_alpha
    px, py, s = (torch.as_tensor(a) for a in lanes(256, 64, 4, seed=10))
    L = path.li_path(cs, px, py, s, max_depth=2)[0]
    assert torch.isfinite(L).all()
    monkeypatch.undo()
    px, py, s = (torch.as_tensor(a) for a in lanes(256, 8, 1, seed=10))
    for name in ("noise3", "_map_p3"):
        monkeypatch.setattr(textures, name, boom)
    import pbrt_tpu_torch.textures.image as IM
    for name in ("sample_atlas", "sample_atlas_aniso", "_bilinear_at_level"):
        monkeypatch.setattr(IM, name, boom)
    cs = load_scene_string(SCENE.replace("{TEX}", CHECKER).replace("{KD}", "ck"), device="cpu")
    assert cs.flags.tex_kinds == (textures.T_CHECKER2D,)
    L = path.li_path(cs, px, py, s, max_depth=2)[0]
    assert torch.isfinite(L).all() and float(L.sum()) > 0

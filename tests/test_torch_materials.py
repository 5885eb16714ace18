"""Materials, BSDF lobe families and fourier tables of the port against
pbrt_tpu on the CPU, on inputs made from a numpy seed: compile_materials
tables bit-equal for every ported kind (mix and fourier included);
compute_lobes per kind within 1e-6; bsdf_f / bsdf_pdf / bsdf_sample per
lobe family with the shading tests' tolerances (sampled directions 2e-5, f and pdf
1e-4 relative); and a gated-off family issues no tensor op."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pbrt_tpu.materials import bsdf as JB, compile_materials as j_compile
from pbrt_tpu.materials import compute_lobes as j_compute_lobes
from pbrt_tpu.materials import material_families as j_families
from pbrt_tpu.materials.fourier import build_fourier_table, read_bsdf_file as j_read
from pbrt_tpu.scene.api import Api as JApi
from pbrt_tpu.scene.parser import parse_file as j_parse_file
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.materials import compile_materials, compute_lobes, material_families
from pbrt_tpu_torch.materials import fourier as F
from pbrt_tpu_torch.scene.api import Api
from pbrt_tpu_torch.scene.bench import write_all_kinds_scene, write_fourier_bsdf
from pbrt_tpu_torch.scene.parser import parse_file
from pbrt_tpu_torch.scene.types import MaterialTable

RTOL = 1e-4


@pytest.fixture(scope="module")
def decls(tmp_path_factory):
    """Every ported kind (the all-kinds scene) plus a fourier material
    whose table is missing and a kind neither package knows, in both
    packages -> (port decls, reference decls, directory)."""
    d = str(tmp_path_factory.mktemp("kinds"))
    path = write_all_kinds_scene(d)
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("WorldEnd", 'Material "fourier" "string bsdffile" "missing.bsdf"\n'
                                         'Material "hair"\nWorldEnd'))
    api, japi = Api(), JApi()
    api.cwd = japi.cwd = d
    parse_file(path, api)
    j_parse_file(path, japi)
    return api.scene.materials, japi.scene.materials, d


def test_compile_materials_tables_equal_reference(decls, caplog):
    """kind, const, misc, tex and child bit-equal; the fourier table
    (densified, padded, a0y and its cdf) bit-equal; the unreadable table
    logged and its material matte Kd 0.5, and the unknown kind matte, as
    in the reference; the lobe families equal material_families'."""
    pdecls, jdecls, d = decls
    kind, const, misc, tex, child, tables = compile_materials(pdecls, d)
    jm, _, jtables, _ = j_compile(jdecls, cwd=d)
    for got, want in ((kind, jm.kind), (const, jm.const), (misc, jm.misc), (tex, jm.tex),
                      (child, jm.child)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert "missing.bsdf" in caplog.text and kind[-2] == 0 and np.all(const[-2, 0] == 0.5)
    assert kind[-1] == 0 and np.all(const[-1, 0] == 0.5)
    assert sorted(set(kind.tolist())) == [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12]
    assert len(tables) == len(jtables) == 1
    ft, jft = F.fourier_tables(tables), build_fourier_table(jtables)
    for k in ("mu", "a", "eta", "n_mu", "a0y", "cdf"):
        np.testing.assert_array_equal(ft[k], np.asarray(getattr(jft, k)), err_msg=k)
    assert material_families(pdecls) == j_families(jdecls) == (True,) * 5
    assert material_families(pdecls[:3]) == j_families(jdecls[:3])


def test_compute_lobes_matches_reference_per_kind(decls):
    """2,048 lanes over every row, u_mix random: every Lobes field within
    1e-6 (a field the port leaves None is the reference's default)."""
    pdecls, jdecls, d = decls
    kind, const, misc, tex, child, _ = compile_materials(pdecls, d)
    jm = j_compile(jdecls, cwd=d)[0]
    t = lambda a: torch.as_tensor(a)
    mats = MaterialTable(t(kind), t(const), t(misc), t(tex), t(child))
    n = 2048
    rng = np.random.default_rng(2)
    mat = rng.integers(-1, len(pdecls), n).astype(np.int32)
    u_mix = rng.uniform(0, 1, n).astype(np.float32)
    lb = compute_lobes(mats, None, t(mat), torch.zeros((n, 2)), torch.zeros((n, 3)), None,
                       (False,) * 10, (), t(u_mix))
    ref = j_compute_lobes(jm, None, jnp.asarray(mat), jnp.zeros((n, 2)), jnp.zeros((n, 3)),
                          jnp.asarray(u_mix), (False,) * 10)
    defaults = {"eta3": 1.0, "fourier_id": -1}
    for f in ("kd", "ks", "rough_u", "rough_v", "eta", "sigma", "kt_diff", "glossy_kind",
              "eta3", "k3", "rd_blend", "kt_gloss", "rough_tu", "rough_tv", "spec_r", "spec_t",
              "spec_fresnel", "fourier_id", "dist"):
        want = np.asarray(getattr(ref, f))
        got = getattr(lb, f)
        got = np.full_like(want, defaults.get(f, 0)) if got is None else got.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f)
    resolved = np.asarray(ref.kd).sum(1) + np.asarray(ref.spec_r).sum(1)
    assert (resolved > 0).mean() > 0.5


# one family each: (the port's fields, the reference's fams)
FAMILIES = ["oren", "conductor", "blend", "beckmann", "glossy_t", "diffuse_t", "specular",
            "fourier"]


def _dirs(n, rng):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _family_lobes(family, n, seed):
    """Random lobes of one family beside a diffuse lobe -> (port Lobes,
    reference Lobes, reference fams)."""
    rng = np.random.default_rng(seed)
    u = lambda *s, lo=0.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)
    kd = u(n, 3)
    kd[::4] = 0.0
    p = {"kd": kd, "eta": u(n, lo=1.2, hi=2.0)}
    fams = [False] * 5
    alpha = u(n, lo=0.1, hi=0.8)
    if family == "oren":
        p["sigma"] = u(n, lo=0.0, hi=0.6)
        fams[3] = True
    elif family in ("conductor", "blend", "beckmann"):
        p.update(ks=u(n, 3), rough_u=alpha, rough_v=alpha)
        fams[1] = True
        gk = {"conductor": B.GF_CONDUCTOR, "blend": B.GF_BLEND, "beckmann": B.GF_DIELECTRIC}
        p["glossy_kind"] = np.where(u(n) < 0.7, gk[family], B.GF_DIELECTRIC).astype(np.int32)
        if family == "conductor":
            p.update(eta3=u(n, 3, lo=0.2, hi=1.5), k3=u(n, 3, lo=1.0, hi=4.0))
        elif family == "blend":
            p["rd_blend"] = np.where((p["glossy_kind"] == B.GF_BLEND)[:, None], u(n, 3), 0.0)
        else:
            p["dist"] = np.where(u(n) < 0.6, B.DIST_BECKMANN, B.DIST_GGX).astype(np.int32)
    elif family == "glossy_t":
        p.update(kt_gloss=u(n, 3), rough_tu=alpha, rough_tv=alpha)
        fams[2] = True
    elif family == "diffuse_t":
        p["kt_diff"] = u(n, 3)
        fams[0] = True
    elif family == "specular":
        p.update(spec_r=u(n, 3), spec_t=u(n, 3))
        p["spec_r"][::3] = 0.0
        p["spec_t"][1::3] = 0.0
        p["spec_fresnel"] = np.where(u(n) < 0.3, B.SF_NOOP, B.SF_DIELECTRIC).astype(np.int32)
        fams[4] = True
    else:
        p["fourier_id"] = np.where(u(n) < 0.6, 0, -1).astype(np.int32)
    lb = B.Lobes(**{k: torch.as_tensor(v) for k, v in p.items()})
    jl = JB.Lobes.zeros(n)._replace(**{k: jnp.asarray(v) for k, v in p.items()})
    return lb, jl, tuple(fams)


@pytest.fixture(scope="module")
def ftab(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fourier") / "ripple.bsdf")
    write_fourier_bsdf(path, n_mu=24)
    return (F.table_on(F.fourier_tables([F.read_bsdf_file(path)]), "cpu"),
            build_fourier_table([j_read(path)]))


def close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("family", FAMILIES)
def test_bsdf_family_matches_reference(family, ftab):
    """4,096 lanes of one family: bsdf_f and bsdf_pdf at random directions;
    bsdf_sample's directions within 2e-5, its f and pdf (at the
    reference's direction) within 1e-4, its specular, transmission and
    eta_scale equal."""
    n = 4096
    lb, jl, fams = _family_lobes(family, n, FAMILIES.index(family))
    tab, jtab = ftab if family == "fourier" else (None, None)
    rng = np.random.default_rng(40 + FAMILIES.index(family))
    wo, wi = _dirs(n, rng), _dirs(n, rng)
    two, twi = torch.as_tensor(wo), torch.as_tensor(wi)
    close(B.bsdf_f(lb, two, twi, tab), JB.bsdf_f(jl, jnp.asarray(wo), jnp.asarray(wi), jtab,
                                                  fams=fams))
    close(B.bsdf_pdf(lb, two, twi, tab), JB.bsdf_pdf(jl, jnp.asarray(wo), jnp.asarray(wi), jtab,
                                                      fams=fams))
    u_lobe = rng.uniform(0, 1, n).astype(np.float32)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    bs = B.bsdf_sample(lb, two, torch.as_tensor(u_lobe), torch.as_tensor(u2), tab)
    ref = JB.bsdf_sample(jl, jnp.asarray(wo), jnp.asarray(u_lobe), jnp.asarray(u2), jtab,
                         fams=fams)
    np.testing.assert_array_equal(bs.is_specular.numpy(), np.asarray(ref.is_specular))
    ok = np.asarray(ref.pdf) > 0
    assert ok.mean() > 0.3 and np.mean((bs.pdf.numpy() > 0) == ok) >= 0.999
    close(bs.wi.numpy()[ok], np.asarray(ref.wi)[ok], rtol=1e-5, atol=2e-5)
    spec = bs.is_specular.numpy() & ok
    close(bs.f.numpy()[spec], np.asarray(ref.f)[spec])
    close(bs.pdf.numpy()[spec], np.asarray(ref.pdf)[spec])
    rwi = torch.as_tensor(np.array(ref.wi))
    ns = ok & ~spec
    close(B.bsdf_f(lb, two, rwi, tab).numpy()[ns], np.asarray(ref.f)[ns])
    close(B.bsdf_pdf(lb, two, rwi, tab).numpy()[ns], np.asarray(ref.pdf)[ns])
    trans = np.zeros(n, bool) if bs.is_transmission is None else bs.is_transmission.numpy()
    eta_s = np.ones(n, np.float32) if bs.eta_scale is None else bs.eta_scale.numpy()
    np.testing.assert_array_equal(trans[ok], np.asarray(ref.is_transmission)[ok])
    close(eta_s[ok], np.asarray(ref.eta_scale)[ok], rtol=1e-6)


def test_fourier_sample_and_eval_match_reference(ftab):
    """The fourier table's own sampler, evaluator and pdf at 2,048 lanes:
    directions within 2e-5, f and pdf within 1e-4 (at the reference's
    direction), and pdf_fourier of the sampled direction within 1e-4 of
    the sampler's own pdf."""
    tab, jtab = ftab
    n = 2048
    rng = np.random.default_rng(9)
    wo = _dirs(n, rng)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    flip = rng.uniform(0, 1, n).astype(np.float32)
    tid = np.where(rng.uniform(0, 1, n) < 0.8, 0, -1).astype(np.int32)
    from pbrt_tpu.materials.fourier import (eval_fourier as j_eval, pdf_fourier as j_pdf,
                                            sample_fourier_bsdf as j_sample)
    wi, pdf = F.sample_fourier_bsdf(tab, torch.as_tensor(tid), torch.as_tensor(wo),
                                    torch.as_tensor(u2), torch.as_tensor(flip))
    jwi, jpdf = j_sample(jtab, jnp.asarray(tid), jnp.asarray(wo), jnp.asarray(u2),
                         jnp.asarray(flip))
    close(wi, jwi, rtol=1e-5, atol=2e-5)
    close(pdf, jpdf)
    got = F.pdf_fourier(tab, torch.as_tensor(tid), torch.as_tensor(wo), wi)
    close(got, pdf)
    rwi = torch.as_tensor(np.array(jwi))
    close(F.eval_fourier(tab, torch.as_tensor(tid), torch.as_tensor(wo), rwi),
          j_eval(jtab, jnp.asarray(tid), jnp.asarray(wo), jwi))
    close(F.pdf_fourier(tab, torch.as_tensor(tid), torch.as_tensor(wo), rwi),
          j_pdf(jtab, jnp.asarray(tid), jnp.asarray(wo), jwi))


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with _OpCount() as c:
        fn()
    return c.n


def test_gated_off_family_issues_no_op(monkeypatch):
    """A glossy-only block (matte and plastic) runs no code of another
    family: their helpers raise if called; the same block with every
    other family's fields present but gated off by fams issues exactly as
    many tensor ops; and compute_lobes of a matte / plastic table builds
    no other family's field."""
    lb, _, _ = _family_lobes("conductor", 64, 0)
    glossy = B.Lobes(kd=lb.kd, ks=lb.ks, rough_u=lb.rough_u, rough_v=lb.rough_v, eta=lb.eta)
    rng = np.random.default_rng(1)
    wo, wi = torch.as_tensor(_dirs(64, rng)), torch.as_tensor(_dirs(64, rng))
    u1, u2 = torch.rand(64), torch.rand(64, 2)
    run = lambda b, fams=None: (B.bsdf_f(b, wo, wi, None, fams), B.bsdf_pdf(b, wo, wi, None, fams),
                                B.bsdf_sample(b, wo, u1, u2, None, fams))
    n_glossy = _ops(lambda: run(glossy))
    full, _, _ = _family_lobes("specular", 64, 0)
    for fam in ("oren", "glossy_t", "diffuse_t"):
        for k, v in vars(_family_lobes(fam, 64, 0)[0]).items():
            if v is not None and getattr(full, k) is None:
                setattr(full, k, v)
    for k in ("ks", "rough_u", "rough_v"):
        setattr(full, k, getattr(glossy, k))
    full.kd, full.eta = glossy.kd, glossy.eta
    assert _ops(lambda: run(full, (False, True, False, False, False))) == n_glossy

    def boom(*a, **k):
        raise AssertionError("a gated-off family's code ran")

    for name in ("_oren_nayar_f", "_glossy_t_f", "fresnel_conductor", "refract", "reflect_z",
                 "schlick_fresnel"):
        monkeypatch.setattr(B, name, boom)
    for name in ("eval_fourier", "pdf_fourier", "sample_fourier_bsdf"):
        monkeypatch.setattr(F, name, boom)
    out = run(glossy)
    assert out[2].is_transmission is None and out[2].eta_scale is None
    t = torch.as_tensor
    kind = np.array([0, 1, 0], np.int32)
    mats = MaterialTable(t(kind), torch.rand(3, 10, 3), torch.rand(3, 8), t(np.full((3, 10), -1)),
                         t(np.full((3, 2), -1)))
    lobes = compute_lobes(mats, None, t(np.array([0, 1, 2, 1])), torch.zeros((4, 2)),
                          torch.zeros((4, 3)), None, (False,) * 10, (), None,
                          (False, True, False, False, False), (0, 1))
    assert [k for k, v in vars(lobes).items() if v is not None] == [
        "kd", "ks", "rough_u", "rough_v", "eta"]


# non-view tensor ops of one li_path call (128 lanes, depth 3) on the CPU:
# (count, count before the lobe families were gated). Scenes with a glossy
# material issue exactly the ops they did; matte-only ones drop the glossy
# family's.
UNTOUCHED_OPS = {"bench": (104825, 104825), "textured": (237153, 237153),
                 "quadrics": (56340, 56340), "sphere": (10819, 12892), "diff": (16597, 18670)}


class _KernelOpCount(_OpCount):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", list(UNTOUCHED_OPS))
def test_untouched_scenes_issue_no_new_op(name, tmp_path):
    """The scenes that hold none of the new materials, lights or
    strategies issue no op for them: the count of non-view tensor ops
    (each a device kernel on the card) of one li_path call is as stated."""
    from pbrt_tpu_torch.integrators.path import li_path
    from pbrt_tpu_torch.scene import bench as Bn, load_scene_string
    image = str(tmp_path / "floor.png")
    Bn.write_floor_image(image, size=(48, 40))
    cs = {"bench": lambda: Bn.build_bench_scene(False, "cpu"),
          "textured": lambda: Bn.build_textured_bench_scene(image, False, "cpu"),
          "sphere": lambda: load_scene_string(Bn.SPHERE_SCENE.replace("[256]", "[32]"),
                                              device="cpu"),
          "quadrics": lambda: load_scene_string(Bn.quadric_scene_text(32, 4, 2), device="cpu"),
          "diff": lambda: Bn.build_diff_scene(32, "cpu")}[name]()
    rng = np.random.default_rng(0)
    px, py, s = (torch.as_tensor(a) for a in (rng.integers(0, 32, 128).astype(np.int32),
                                              rng.integers(0, 32, 128).astype(np.int32),
                                              rng.integers(0, 4, 128).astype(np.int32)))
    with torch.no_grad(), _KernelOpCount() as c:
        li_path(cs, px, py, s, max_depth=3)
    assert c.n == UNTOUCHED_OPS[name][0]

"""Subsurface scattering against pbrt_tpu: the BSSRDF's host tables and
per-lane lookups (materials/bssrdf.py), the compiled subsurface and
kdsubsurface rows, li_path on a subsurface and a kdsubsurface knot (against
the reference outputs committed in tests/torch_refs), subsurface scenes
under "bool spectral" "true", and the CLI.

Tolerances: the host tables are numpy float64 in both packages and are
held bit-equal; the lookups run in float32 through log, cos and sin, which
XLA and torch round otherwise, and are held within 2e-5 relative.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import hold_ref
from torch_refs import cases as C

from pbrt_tpu.materials import bssrdf as JS, compile_materials as j_compile
from pbrt_tpu.scene.api import Api as JApi
from pbrt_tpu.scene.parser import parse_string as j_parse_string
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.io.image_io import read_png
from pbrt_tpu_torch.materials import bssrdf as S, compile_materials, compile_subsurface, \
    compute_lobes
from pbrt_tpu_torch.render import Options, render
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.api import Api
from pbrt_tpu_torch.scene.bench import KDSUBSURFACE_KNOT, SUBSURFACE_KNOT, calibration_scene, \
    scene_variant
from pbrt_tpu_torch.scene.parser import parse_string

MATERIALS = "\n".join([
    'Material "subsurface"', SUBSURFACE_KNOT,
    'Material "subsurface" "string name" "Skin1" "float scale" 2 "float eta" 1.4',
    'Material "subsurface" "rgb sigma_a" [0.2 0.1 0.05] "rgb sigma_s" [1 2 3] "float g" 0.3',
    'Material "subsurface" "rgb sigma_prime_s" [2 3 4] "string name" "NoSuchMedium"',
    KDSUBSURFACE_KNOT, 'Material "kdsubsurface"',
    'Material "kdsubsurface" "rgb Kd" [0.9 0.2 0.05] "float mfp" 0.5 "float scale" 3',
    'MakeNamedMaterial "wax" "string type" "subsurface" "float roughness" 0.2',
    'NamedMaterial "wax"', 'Material "matte"'])
RTOL = 2e-5


@pytest.fixture(scope="module")
def decls():
    """The materials above in both packages -> (port decls, reference decls)."""
    text = f"WorldBegin\n{MATERIALS}\nWorldEnd\n"
    api, japi = Api(), JApi()
    parse_string(text, api)
    j_parse_string(text, japi)
    return api.scene.materials, japi.scene.materials


@pytest.mark.parametrize("g,eta", [(0.0, 1.33), (0.3, 1.4)])
def test_host_tables_equal_reference(g, eta):
    """The beam-diffusion table, the radius knots, the effective-albedo
    inversion and the collapsed channel rows bit-equal; the named media
    equal."""
    got, want = S.build_bssrdf_table(g, eta), JS.build_bssrdf_table(g, eta)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert np.array_equal(S.radii_knots(), JS.radii_knots())
    rng = np.random.default_rng(6)
    target = rng.uniform(-0.1, 1.1, 64)
    assert np.array_equal(S.invert_rho_eff(target, g, eta), JS.invert_rho_eff(target, g, eta))
    for _ in range(8):
        st, rho = rng.uniform(0.1, 50, 3), rng.uniform(0, 1, 3)
        for a, b in zip(S.dense_channel_rows(st, rho, g, eta),
                        JS.dense_channel_rows(st, rho, g, eta)):
            assert np.array_equal(a, b)
    assert S.MEASURED_SS == JS.MEASURED_SS and len(S.MEASURED_SS) == 47
    for name in list(S.MEASURED_SS)[::5] + ["marble", "NoSuchMedium"]:
        a, b = S.get_medium_scattering_properties(name), JS.get_medium_scattering_properties(name)
        assert (a is None) == (b is None)
        if a is not None:
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_lookups_match_reference():
    """table_sr, table_pdf_sr, table_sample_sr and fresnel_moment1 on
    4,096 seeded lanes over the rows of three materials: within 2e-5
    relative (and 1e-7 absolute)."""
    rng = np.random.default_rng(8)
    n = 4096
    rows = [S.dense_channel_rows(rng.uniform(1, 60, 3), rng.uniform(0.2, 1, 3)) for _ in range(3)]
    pick = rng.integers(0, 3, n)
    prof = np.stack([rows[i][0] for i in pick])
    cdf = np.stack([rows[i][1] for i in pick])
    reff = np.stack([rows[i][2] for i in pick])
    st = rng.uniform(1, 60, (n, 3)).astype(np.float32)
    r = np.exp(rng.uniform(np.log(1e-5), np.log(0.5), n)).astype(np.float32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    T, J = torch.as_tensor, jnp.asarray
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-7)
    close(S.table_sr(T(prof), T(st), T(r)), JS.table_sr(J(prof), J(st), J(r)))
    close(S.table_pdf_sr(T(prof), T(reff), T(st), T(r)),
          JS.table_pdf_sr(J(prof), J(reff), J(st), J(r)))
    radii = S.radii_knots()
    ch = rng.integers(0, 3, n)
    c_rows, c_reff, c_st = cdf[np.arange(n), ch], reff[np.arange(n), ch], st[np.arange(n), ch]
    close(S.table_sample_sr(T(c_rows), T(c_reff), T(c_st), T(radii), T(u)),
          JS.table_sample_sr(J(c_rows), J(c_reff), J(c_st), J(radii), J(u)))
    eta = rng.uniform(0.5, 2.0, n).astype(np.float32)
    close(S.fresnel_moment1(T(eta)), JS.fresnel_moment1(J(eta)))


def test_compiled_rows_equal_reference(decls):
    """Subsurface and kdsubsurface compile to the reference's rows: the
    glass-like boundary's kind, constants and misc, and the BSSRDF rows
    (flag, sigma_t, albedo, the collapsed profile and CDF rows and the
    effective albedos) bit-equal; compute_lobes flags their lanes."""
    pdecls, jdecls = decls
    kind, const, misc, tex, child, _ = compile_materials(pdecls)
    jm = j_compile(jdecls)[0]
    for got, want in ((kind, jm.kind), (const, jm.const), (misc, jm.misc), (tex, jm.tex)):
        np.testing.assert_array_equal(got, np.asarray(want))
    rows = compile_subsurface(pdecls, misc)
    for got, want in zip(rows, (jm.sss, jm.sss_prof, jm.sss_cdf, jm.sss_rhoeff)):
        np.testing.assert_array_equal(got, np.asarray(want))
    want_flags = [d.kind in ("subsurface", "kdsubsurface") for d in pdecls]
    assert rows[0][:, 0].tolist() == [float(f) for f in want_flags] and sum(want_flags) == 9
    from pbrt_tpu_torch.scene.types import MaterialTable
    t = torch.as_tensor
    mats = MaterialTable(t(kind), t(const), t(misc), t(tex), t(child), *(t(a) for a in rows))
    ids = torch.arange(len(pdecls))
    lb = compute_lobes(mats, None, ids, torch.zeros(len(ids), 2), torch.zeros(len(ids), 3),
                       kinds=tuple(sorted(set(kind.tolist()))))
    assert lb.sss_flag.tolist() == want_flags


@pytest.mark.parametrize("name", ["path_subsurface", "path_kdsubsurface"])
def test_li_path_matches_reference(name):
    """li_path on a subsurface and a kdsubsurface knot, 1,024 lanes at
    depth 3, the probe chain included: hold_li's rule, but for the live-ray
    counts, which are held within 2 lanes. The probes' chords graze the
    knot's edges, where the port's BVH walk (B1's naive-shear triangle
    test) and the reference's XLA walk (the watertight test) may take the
    other side of an edge."""
    ref = C.load(name)
    text = C.path_case_scene(name)
    assert text == ref["scene"]
    cs = load_scene_string(text, device="cpu")
    assert cs.flags.has_subsurface
    L, p_film, _, cnt = li_path(cs, *(torch.as_tensor(ref[k]) for k in ("px", "py", "s")),
                                max_depth=C.DEPTH)
    assert hold_ref(L, p_film, None, ref) > 0.05
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        assert abs(int(cnt[k]) - int(ref[f"cnt_{k}"])) <= 2, k


def test_spectral_subsurface_renders_in_rgb():
    """A scene with a BSSRDF under "bool spectral" "true" renders as it does
    without the flag (the reference renders it in RGB); without a BSSRDF
    the same scene is spectral."""
    line = 'Integrator "path" "integer maxdepth" 2'
    text = scene_variant(calibration_scene("knot", line, res=8, spp=2),
                         knot_material=SUBSURFACE_KNOT, knot_line=C.CAL_KNOT_LINE)
    opts = Options(wavefront_size=64)
    want = render(load_scene_string(text, device="cpu"), opts)[0]
    got = render(load_scene_string(text.replace(line, line + ' "bool spectral" "true"'),
                                   device="cpu"), opts)[0]
    assert float(want.sum()) > 0 and torch.equal(got, want)
    assert load_scene_string(calibration_scene("knot", line + ' "bool spectral" "true"'),
                             device="cpu").flags.spectral


@pytest.mark.parametrize("material", ["subsurface", "kdsubsurface", "spectral"])
def test_cli_renders_subsurface(material, tmp_path):
    """python -m pbrt_tpu_torch --device cpu renders a subsurface knot, a
    kdsubsurface knot and the subsurface knot under "bool spectral"
    "true" to a lit image."""
    from pbrt_tpu_torch.__main__ import main
    line = 'Integrator "path" "integer maxdepth" 2'
    if material == "spectral":
        line += ' "bool spectral" "true"'
    mat = KDSUBSURFACE_KNOT if material == "kdsubsurface" else SUBSURFACE_KNOT
    text = scene_variant(calibration_scene("knot", line, res=8, spp=1), knot_material=mat,
                         knot_line=C.CAL_KNOT_LINE)
    (tmp_path / "s.pbrt").write_text(text)
    assert main(["--device", "cpu", "--quiet", "--outfile", str(tmp_path / "s.png"),
                 str(tmp_path / "s.pbrt")]) == 0
    img = read_png(str(tmp_path / "s.png"))
    assert img.shape == (8, 8, 3) and img.max() > 0

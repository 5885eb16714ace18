"""The benchmark's dragon_microfacet configuration on the CPU, at a size a
test run holds (16 x 16 pixels at 16 spp, the knot at an eighth of its
segments): the plain reference (benchmark/reference.py with its metal and
plastic plugins) agrees with the port's pixels, its bfloat16 control fails
the configuration's limits, and so does each fault planted under the timed
path (benchmark/faults.py). Then the reference's microfacet plugins alone:
their lobes against the port's (materials/bsdf.py), the pdf that sampling
reports, reciprocity, the hemispheres, and the sampled directions against
the pdf. The card's readings, at the configuration's own size, come from
benchmark/control.py."""
from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmark"))

import control  # noqa: E402
import faults  # noqa: E402
import harness  # noqa: E402
import plugins  # noqa: E402
import refmath  # noqa: E402

from pbrt_tpu_torch.materials import bsdf as B  # noqa: E402

CELL = "dragon_microfacet.wf4m"
SMALL = {"resolution": (16, 16), "spp": 16, "mesh_scale": 0.125, "wavefront_size": 4096,
         "pixels": 96}
SEEDS = (7, 2147483659, 4294967311)
MATERIALS = ("metal", "plastic")


def _limits():
    return harness.resolve(ROOT, harness.load_benchmark(ROOT), CELL)[1]["check"]["limits"]


@pytest.fixture(scope="module")
def readings():
    """{seed: control.readings_for_seed(...)}: the program, the control and
    the faults on the CPU at the small size."""
    return {s: control.readings_for_seed(ROOT, CELL, s, "cpu", SMALL, True) for s in SEEDS}


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_agrees_with_the_port(readings, seed):
    got = readings[seed]["program"]
    for k, lim in _limits().items():
        assert got[k] <= lim, (k, got[k], lim)


@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_control_fails(readings, seed):
    got = readings[seed]["control"]
    assert any(got[k] > lim for k, lim in _limits().items()), got


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_fault_is_caught(readings, fault):
    for seed in SEEDS:
        got = readings[seed][fault]
        assert any(got[k] > lim for k, lim in _limits().items()), (seed, got)


# --- the reference's microfacet plugins ---------------------------------

N = 4096
# the configuration's own parameters, as the scene states them
PARAMS = {
    "metal": {"eta": ("rgb", [0.2004, 0.9240, 1.1022]), "k": ("rgb", [3.9129, 2.4528, 2.1421]),
              "roughness": ("float", [0.01])},
    "plastic": {"Kd": ("rgb", [0.4, 0.4, 0.4]), "Ks": ("rgb", [0.3, 0.3, 0.3]),
                "roughness": ("float", [0.1])},
}


def _material(name, n=N, params=None):
    """(the plugin, its parameter table broadcast to n lanes in float32)."""
    mod = plugins.load("materials", name)
    parsed = mod.parse(PARAMS[name] if params is None else params)
    table = {k: torch.as_tensor(np.broadcast_to(np.asarray(v, np.float64),
                                                (n,) + np.shape(v)).copy(), dtype=torch.float32)
             for k, v in parsed.items()}
    return mod, table


def _dirs(seed, n=N, upper=True):
    """n unit directions, on the +z side where upper, else on either."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((n, 3), generator=g)
    v = v / v.norm(dim=-1, keepdim=True)
    if upper:
        v[:, 2] = v[:, 2].abs().clamp(min=1e-3)
        v = v / v.norm(dim=-1, keepdim=True)
    return v


def _u(seed, n=N, k=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, k), generator=g).clamp(max=refmath.ONE_MINUS_EPS)


def _port_lobes(name, m):
    """The port's Lobes of the same material (compute_lobes' fields)."""
    n = m["au"].shape[0]
    lb = B.Lobes(kd=torch.zeros((n, 3)), ks=torch.ones((n, 3)), rough_u=m["au"],
                 rough_v=m["av"], eta=torch.full((n,), 1.5))
    if name == "metal":
        lb.glossy_kind = torch.full((n,), B.GF_CONDUCTOR)
        lb.eta3, lb.k3 = m["eta"], m["k"]
    else:
        lb.kd, lb.ks = m["Kd"], m["Ks"]
    return lb


FAMS = (False, True, False, False, False)


@pytest.mark.parametrize("name", MATERIALS)
def test_lobes_follow_the_ports(name):
    """f, the pdf and the sampled directions of the reference's plugin
    equal the port's bsdf_f, bsdf_pdf and bsdf_sample up to rounding, on
    both sides of the surface."""
    mod, m = _material(name)
    lb = _port_lobes(name, m)
    wo, wi = _dirs(1, upper=False), _dirs(2, upper=False)
    f, pdf = mod.f_pdf(m, wo, wi)
    torch.testing.assert_close(f, B.bsdf_f(lb, wo, wi, fams=FAMS), rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(pdf, B.bsdf_pdf(lb, wo, wi, fams=FAMS), rtol=2e-5, atol=1e-6)
    u_lobe, u_dir = _u(3)[:, 0], _u(4, k=2)
    wi_s, f_s, pdf_s, eta = mod.sample(m, wo, u_lobe, u_dir)
    bs = B.bsdf_sample(lb, wo, u_lobe, u_dir, fams=FAMS)
    assert eta is None and not bs.is_specular.any()
    torch.testing.assert_close(wi_s, bs.wi, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f_s, bs.f, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pdf_s, bs.pdf, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", MATERIALS)
def test_sampled_pdf_is_f_pdfs(name):
    """sample's pdf is f_pdf's at the direction drawn, where it drew one,
    and so is f; some draws of each lobe succeed."""
    mod, m = _material(name)
    wo = _dirs(5)
    wi, f, pdf, _ = mod.sample(m, wo, _u(6)[:, 0], _u(7, k=2))
    f2, pdf2 = mod.f_pdf(m, wo, wi)
    ok = pdf > 0
    assert ok.float().mean() > 0.8
    assert torch.equal(pdf[ok], pdf2[ok]) and torch.equal(f[ok], f2[ok])


@pytest.mark.parametrize("name", MATERIALS)
def test_f_is_reciprocal(name):
    """f(wo, wi) = f(wi, wo) up to float32 rounding (G sums its two Lambdas
    and F reads wi . wh in the order given)."""
    mod, m = _material(name)
    wo, wi = _dirs(8), _dirs(9)
    torch.testing.assert_close(mod.f_pdf(m, wo, wi)[0], mod.f_pdf(m, wi, wo)[0],
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name", MATERIALS)
def test_f_and_pdf_vanish_across_hemispheres(name):
    mod, m = _material(name)
    wo, wi = _dirs(10), _dirs(11)
    for a, b in ((wo, -wi), (-wo, wi)):
        f, pdf = mod.f_pdf(m, a, b)
        assert torch.equal(f, torch.zeros_like(f)) and torch.equal(pdf, torch.zeros_like(pdf))
    # from below, f and the pdf mirror those from above
    f_up, pdf_up = mod.f_pdf(m, wo, wi)
    f_dn, pdf_dn = mod.f_pdf(m, -wo, -wi)
    torch.testing.assert_close(f_dn, f_up, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(pdf_dn, pdf_up, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", MATERIALS)
def test_sampled_directions_follow_the_pdf(name):
    """From one outgoing direction, the share of drawn directions within
    each of four cones about the mirror direction matches the pdf's
    integral over the cone (uniform directions in the cone), and the pdf
    integrates to the share of successful draws over the hemisphere."""
    n = 1 << 18
    mod, m = _material(name, n)
    wo = torch.tensor([[0.5, 0.0, math.sqrt(0.75)]]).expand(n, 3)
    wi, _, pdf, _ = mod.sample(m, wo, _u(12, n)[:, 0], _u(13, n, 2))
    drawn = pdf > 0
    mirror = torch.tensor([-0.5, 0.0, math.sqrt(0.75)])
    for cos_max in (0.999, 0.99, 0.9, 0.5):
        share = (drawn & (wi @ mirror >= cos_max)).float().mean()
        # uniform directions in the cone about the mirror direction
        u = _u(14 + int(1000 * cos_max), n, 2)
        z = 1.0 - u[:, 0] * (1.0 - cos_max)
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2 * math.pi * u[:, 1]
        local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
        t = torch.tensor([0.0, 1.0, 0.0])
        s = torch.linalg.cross(t, mirror)
        d = local[:, :1] * s + local[:, 1:2] * t + local[:, 2:] * mirror
        integral = mod.f_pdf(m, wo, d)[1].mean() * 2 * math.pi * (1.0 - cos_max)
        assert abs(float(share) - float(integral)) < 0.01 + 0.03 * float(share), \
            (cos_max, float(share), float(integral))
    # nearly uniform on the upper hemisphere: density 1 / (2 pi)
    up = _dirs(15, n)
    total = mod.f_pdf(m, wo, up)[1].mean() * 2 * math.pi
    assert abs(float(total) - float(drawn.float().mean())) < 0.02

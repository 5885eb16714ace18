"""The whitted and directlighting integrators, the render dispatch and the
front end's forms that the reference renders, against pbrt_tpu.

The integrators are held against the reference's outputs committed in
tests/torch_refs (make_refs.py ran pbrt_tpu jitted on the CPU on the same
scene text, lanes and seed), so no test here compiles a JAX integrator.
"""
import numpy as np
import pytest
import torch

from torch_port_helpers import hold_image, hold_ref, renders_as_without_spectral
from torch_refs import cases as C

from pbrt_tpu_torch.integrators.direct import li_direct
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.integrators.volpath import li_volpath
from pbrt_tpu_torch.integrators.whitted import li_whitted
from pbrt_tpu_torch.io.image_io import read_pfm, read_png
from pbrt_tpu_torch.render import Options, li_fn, render, render_sampler_integrator
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.bench import calibration_scene


@pytest.mark.parametrize("name,scene,kind,strategy", C.LI_CASES, ids=[c[0] for c in C.LI_CASES])
def test_li_matches_reference(name, scene, kind, strategy):
    """1,024 lanes at depth 3 through the scene's own dispatch: >= 99% of
    lanes within rtol 1e-3 / atol 1e-4, the means within 1%, p_film
    bit-equal and the same live-ray counts."""
    ref = C.load(name)
    text = C.case_scene(scene, kind, strategy)
    assert text == ref["scene"]
    cs = load_scene_string(text, device="cpu")
    L, p_film, _, cnt = li_fn(cs)(cs, *(torch.as_tensor(ref[k]) for k in ("px", "py", "s")))
    assert hold_ref(L, p_film, cnt, ref) > 0.01
    if kind == "whitted":
        assert int(cnt["shadow_rays"]) > 0
    if scene == "knot":
        assert int(cnt["bounce_rays"]) > 0   # the glass sphere's specular lanes


@pytest.mark.parametrize("line,fn,kw", [
    ('Integrator "path" "integer maxdepth" 3 "float rrthreshold" 0.5', li_path,
     {"max_depth": 3, "rr_threshold": 0.5}),
    ('Integrator "volpath" "integer maxdepth" 2', li_volpath,
     {"max_depth": 2, "rr_threshold": 1.0}),
    ('Integrator "whitted"', li_whitted, {"max_depth": 5}),
    ('Integrator "directlighting" "integer maxdepth" 4', li_direct,
     {"max_depth": 4, "strategy": "all"}),
    ('Integrator "directlighting" "string strategy" "one"', li_direct,
     {"max_depth": 5, "strategy": "one"}),
    ('Integrator "ambientocclusion" "integer maxdepth" 2 "float rrthreshold" 0.5', li_path,
     {"max_depth": 2}),
], ids=["path", "volpath", "whitted", "direct_all", "direct_one", "unnamed"])
def test_li_fn_dispatches_as_the_reference(line, fn, kw):
    """The reference's _li_fn: each kind's function and parameters; a kind
    it does not name takes li_path with maxdepth alone."""
    cs = load_scene_string(SMOKE.replace('Integrator "path" "integer maxdepth" 1', line),
                           device="cpu")
    li = li_fn(cs)
    assert li.func is fn and li.keywords == kw


SMOKE = C.INTEGRATOR_SMOKE
# (form, where it goes: the directive it follows or replaces, the text)
C2_FORMS = {
    "unnamed_integrator": ('Integrator "path" "integer maxdepth" 1',
                           'Integrator "ambientocclusion" "integer maxdepth" 1'),
    "integrator_params": ('Integrator "path" "integer maxdepth" 1',
                          'Integrator "path" "integer maxdepth" 1 "integer pixelbounds" [0 4 0 4] '
                          '"bool spectral" "false"'),
    "option": ("WorldBegin", 'Option "render" "bool disablepixeljitter" "true"\nWorldBegin'),
    "accelerator_none": ("WorldBegin", 'Accelerator "none"\nWorldBegin'),
    "splitmethod": ("WorldBegin", 'Accelerator "bvh" "string splitmethod" "foo"\nWorldBegin'),
    "unknown_light": ("AttributeBegin", 'LightSource "foo" "rgb L" [1 1 1]\nAttributeBegin'),
    "vector_S": ('"point P" [-1 -1 0  1 -1 0  0 1 0]',
                 '"point P" [-1 -1 0  1 -1 0  0 1 0] "vector S" [1 0 0 1 0 0 1 0 0]'),
    "loopsubdiv_alpha": ('"point P" [-1 -1 -1  1 -1 -1  1 1 -1  -1 1 -1]',
                         '"point P" [-1 -1 -1  1 -1 -1  1 1 -1  -1 1 -1] "float alpha" 0.5'),
    "transform_times": ("WorldBegin", "WorldBegin\nTransformTimes 0 2"),
    "film_kind": ('Film "image"', 'Film "gbuffer"'),
}


@pytest.mark.parametrize("form", list(C2_FORMS))
def test_repaired_forms_render_as_without_them(form):
    """Each form that the reference renders builds here and renders exactly
    as the same scene does without it (the reference ignores it, or an
    unnamed integrator kind is li_path with maxdepth)."""
    old, new = C2_FORMS[form]
    assert old in SMOKE
    opts = Options(wavefront_size=64)
    want, _, _ = render_sampler_integrator(load_scene_string(SMOKE, device="cpu"), opts)
    got, _, _ = render(load_scene_string(SMOKE.replace(old, new, 1), device="cpu"), opts)
    assert float(want.sum()) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("line,what", [
    ('Integrator "sppm" "bool spectral" "true"', "spectral"),
    ('Integrator "mlt" "bool spectral" "true"', "spectral"),
    ('Integrator "path" "bool spectral" "true"', "spectral"),
    ('Integrator "whitted" "bool spectral" "true"', "spectral"),
    ('Integrator "directlighting" "bool spectral" "true"', "spectral"),
    ('Integrator "volpath" "bool spectral" "true"', "spectral"),
])
def test_unported_forms_still_raise(line, what):
    """Each integrator under "bool spectral" "true" (the forms raised
    until the port's spectral mode) does what the reference's does: sppm
    raises (the reference fails there too, ROADMAP C); path and
    directlighting render spectrally and hold the reference's image
    (hold_image); mlt (its bdpt target), whitted and volpath have no
    spectral branch and render bit-equal to the scene without the flag."""
    text = C.integrator_form_scene(line)
    cs = load_scene_string(text, device="cpu")
    assert getattr(cs.flags, what)
    if "sppm" in line:
        with pytest.raises(NotImplementedError, match=what):
            render(cs)
    elif line in C.SPECTRAL_INTEGRATOR_FORMS:
        hold_image(render(cs)[0], C.spectral_form_image(text))
    elif "mlt" in line:
        renders_as_without_spectral(text.replace(
            '"bool spectral"', '"integer bootstrapsamples" 1024 "integer chains" 256 '
                               '"integer mutationsperpixel" 4 "bool spectral"'))
    else:
        renders_as_without_spectral(text)


def test_cli_renders_every_new_integrator(tmp_path):
    """whitted, directlighting (both strategies), bdpt, mlt (both targets)
    and sppm (its radius from --sppm-radius) through the CLI (render_file
    -> render): an image each, finite and lit; whitted's equals
    render_sampler_integrator's."""
    from pbrt_tpu_torch.__main__ import main
    lines = {"whitted": 'Integrator "whitted" "integer maxdepth" 2',
             "direct_all": 'Integrator "directlighting" "integer maxdepth" 2',
             "direct_one": 'Integrator "directlighting" "string strategy" "one"',
             "bdpt": 'Integrator "bdpt" "integer maxdepth" 2',
             "mlt": 'Integrator "mlt" "integer maxdepth" 2 "integer bootstrapsamples" 256 '
                    '"integer chains" 64 "integer mutationsperpixel" 4',
             "mlt_path": 'Integrator "mlt" "string target" "path" "integer maxdepth" 2 '
                         '"integer bootstrapsamples" 256 "integer chains" 64',
             "sppm": 'Integrator "sppm" "integer maxdepth" 3 "integer numiterations" 2 '
                     '"integer photonsperiteration" 4096 "float radius" 40'}
    paths = []
    for name, line in lines.items():
        ext = "pfm" if name == "sppm" else "png"   # sppm's image is read back as floats
        text = calibration_scene("point", line, res=8, spp=1).replace(
            'Film "image"', f'Film "image" "string filename" "{tmp_path / name}.{ext}"')
        paths.append(tmp_path / f"{name}.pbrt")
        paths[-1].write_text(text)
    assert main(["--device", "cpu", "--quiet", "--sppm-radius", "0.5", *map(str, paths)]) == 0
    for name in lines:
        if name == "sppm":
            img = read_pfm(str(tmp_path / "sppm.pfm"))
            assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.max() > 0.05
        else:
            img = read_png(str(tmp_path / f"{name}.png"))
            assert img.shape == (8, 8, 3) and img.max() > 20, name
    cs = load_scene_string(paths[0].read_text(), device="cpu")
    a, _, _ = render(cs)
    b, _, _ = render_sampler_integrator(cs)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    # the CLI's sppm image is the one at --sppm-radius, not at the scene's radius
    cs = load_scene_string(paths[-1].read_text(), device="cpu")
    cli = read_pfm(str(tmp_path / "sppm.pfm"))
    for radius, same in ((0.5, True), (0.0, False)):
        img, _, _ = render(cs, Options(sppm_radius=radius))
        assert np.array_equal(img.numpy(), cli) == same, radius

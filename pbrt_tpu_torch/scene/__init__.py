"""Scene front end: parse .pbrt text and compile it into device tables."""
from pbrt_tpu_torch.scene.build import build_scene, load_scene, load_scene_string  # noqa: F401

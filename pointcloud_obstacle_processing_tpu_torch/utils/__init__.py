from .scene import Scene, SceneSpec, make_scene

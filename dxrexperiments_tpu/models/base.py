"""Render pipeline interface.

JAX replacement for the abstract ``RaytracingPipeline`` contract
(/root/reference/include/RaytracingPipeline.h:8-39). GPU resources
(output UAVs, SBTs, constant buffers) become jnp arrays and pytrees; the
``render`` method is a thin host wrapper around one jitted step.
"""

from __future__ import annotations

import abc
import time

import numpy as np

from ..core.camera import Camera, camera_params
from ..scene.materials import Material
from ..scene.scene import Scene


class RaytracingPipeline(abc.ABC):
    """Contract parity (update/render/set_scene/add_material/set_camera/
    get_output, RaytracingPipeline.h:14-36)."""

    name: str = "pipeline"

    def __init__(self):
        self.camera: Camera | None = None
        self.scene_data: dict | None = None
        self.materials: list[Material] = []
        self.active = True

    # -- assembly (parity order with DXRExperimentsApp::InitRaytracing) ---- #
    def set_scene(self, scene: Scene) -> None:
        # Per-instance material binding: the reference's pipelines stamp
        # material N onto instance N's hit records
        # (/root/reference/src/ProgressiveRaytracingPipeline.cpp:220-226).
        if self.materials:
            for i, inst in enumerate(scene.instances):
                if inst.material_override is None and i < len(self.materials):
                    inst.material_override = scene.add_material(
                        self.materials[i]
                    )
        # Scenes with their own light rig keep it; otherwise the pipeline
        # owns (and animates) the reference default rig
        # (/root/reference/src/ProgressiveRaytracingPipeline.cpp:197-208).
        self.owns_lights = scene.lights is None
        self.scene_data = scene.build()

    def set_scene_data(self, scene_data: dict) -> None:
        """Attach an already-lowered scene pytree (e.g. from
        Scene.build_two_level()) instead of re-lowering a Scene graph."""
        self.owns_lights = False
        self.scene_data = scene_data

    def add_material(self, material: Material) -> None:
        self.materials.append(material)

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera

    def create_output_resource(self, width: int, height: int) -> None:
        """(Re)allocate output images; called on init and resize
        (parity with createOutputResource, RaytracingPipeline.h:19)."""
        self.width = width
        self.height = height

    # -- per-frame ---------------------------------------------------------- #
    @abc.abstractmethod
    def update(self, elapsed_time: float, elapsed_frames: int) -> None:
        ...

    @abc.abstractmethod
    def render(self) -> None:
        ...

    @abc.abstractmethod
    def get_output(self, index: int = 0):
        ...

    @property
    def num_outputs(self) -> int:
        return 1

    # -- shared helpers ------------------------------------------------------ #
    def _frame_camera_params(self, frame_count: int, accum_count: int, rng) -> dict:
        """CameraParams with the per-frame sub-pixel jitter draw
        (/root/reference/src/ProgressiveRaytracingPipeline.cpp:188-195)."""
        x_jitter = (rng.random() - 0.5) / float(self.width)
        y_jitter = (rng.random() - 0.5) / float(self.height)
        return camera_params(
            self.camera,
            jitter=(x_jitter, y_jitter),
            frame_count=frame_count,
            accum_count=accum_count,
        )


def wall_seed() -> int:
    return int(time.time() * 1000) & 0xFFFFFFFF


def has_camera_moved(camera: Camera, last_vp: np.ndarray | None) -> bool:
    """Parity with hasCameraMoved
    (/root/reference/src/ProgressiveRaytracingPipeline.cpp:170-175)."""
    if last_vp is None:
        return True
    return not np.array_equal(camera.view_proj_matrix(), last_vp)

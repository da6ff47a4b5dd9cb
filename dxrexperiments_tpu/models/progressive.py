"""Progressive (accumulation) path tracing pipeline.

JAX replacement for ``ProgressiveRaytracingPipeline``
(/root/reference/src/ProgressiveRaytracingPipeline.cpp): per-frame update
mirrors the reference (camera-moved accumulation reset, jitter draw, animated
sun, dirty-flag reset from UI), and the render step is one jitted function
that traces a sample and folds it into the running average

    accum = (accumCount * prev + cur) / (accumCount + 1)

exactly as the RayGen shader does (ProgressiveRaytracing.hlsl:36-38),
skipping work once accumCount reaches maxIterations (ibid.:14-16).

The accumulation state (image, count, last camera VP) is an explicit,
checkpointable pytree — the reference's restartable-progress affordance
(SURVEY.md §5 checkpoint/resume) made first-class.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.lights import default_lights
from ..trace.integrator import default_options, render_sample, scene_geometry
from .base import RaytracingPipeline, has_camera_moved, wall_seed


@functools.partial(jax.jit, static_argnames=("width", "height", "ao_only"))
def progressive_step(
    scene: dict,
    options: dict,
    camera: dict,
    accum: jnp.ndarray,
    max_iterations: jnp.ndarray,
    width: int,
    height: int,
    ao_only: bool = False,
) -> jnp.ndarray:
    """One accumulation step with the scene as an argument (reference
    implementation; make_progressive_step is the production step)."""

    def converged(_):
        return accum

    def sample(_):
        out = render_sample(
            scene,
            options,
            camera,
            width,
            height,
            mode="progressive",
            ao_only=ao_only,
            jitter_scale=30.0,
        )
        cur = out["color"]
        count = camera["accum_count"]
        return (count * accum + cur) / (count + 1.0)

    return jax.lax.cond(
        camera["accum_count"] >= max_iterations.astype(jnp.float32),
        converged,
        sample,
        None,
    )


def make_progressive_step(
    scene: dict,
    width: int,
    height: int,
    ao_only: bool = False,
    samples_per_step: int = 1,
    refraction: bool = False,
):
    """Compile the accumulation step; geometry, lights and env are
    arguments (see trace.integrator.make_render_step). Returns
    ``step(accum, options, camera, lights, env, max_iterations,
    geo_arg=None)``; ``geo_arg`` (scene_geometry of a scene with the same
    structure, e.g. a refitted two-level one) defaults to this scene's.

    samples_per_step > 1 renders S decorrelated samples per dispatch (camera
    pytrees stacked on a leading [S] axis, one sample after another under
    lax.map) and folds their mean in — SPP batching in one device call.
    """
    geo = scene_geometry(scene)
    env_kind = int(scene["env"]["kind"])
    s_count = samples_per_step

    @jax.jit
    def inner(accum, options, camera, lights, env, max_iterations, geo_in):
        full = dict(geo_in, lights=lights, env=env)

        def render_one(cam):
            return render_sample(
                full,
                options,
                cam,
                width,
                height,
                mode="progressive",
                ao_only=ao_only,
                jitter_scale=30.0,
                env_kind=env_kind,
                refraction=refraction,
            )["color"]

        if s_count == 1:
            base_count = camera["accum_count"]

            def sample(_):
                return (base_count * accum + render_one(camera)) / (base_count + 1.0)
        else:
            base_count = camera["accum_count"][0]

            def sample(_):
                mean = jnp.mean(jax.lax.map(render_one, camera), axis=0)
                return (base_count * accum + s_count * mean) / (base_count + s_count)

        def converged(_):
            return accum

        return jax.lax.cond(
            base_count >= max_iterations.astype(jnp.float32),
            converged,
            sample,
            None,
        )

    def step(accum, options, camera, lights, env, max_iterations, geo_arg=None):
        return inner(
            accum, options, camera, lights, env, max_iterations,
            geo if geo_arg is None else geo_arg,
        )

    return step


class ProgressiveRaytracingPipeline(RaytracingPipeline):
    name = "Progressive Raytracing"

    def __init__(
        self,
        width: int = 512,
        height: int = 512,
        seed: int | None = None,
        samples_per_frame: int = 1,
    ):
        super().__init__()
        self.options = default_options()
        self.samples_per_frame = max(int(samples_per_frame), 1)
        self.max_iterations = 1024
        self.frame_accumulation_enabled = True
        self.animation_paused = True  # reference default (ctor :30)
        self.ao_only = False
        # beyond-reference transmission bounce (trace_rays refraction=);
        # static compile flag, off = exact reference parity
        self.refraction = False
        self.rng = np.random.default_rng(wall_seed() if seed is None else seed)
        self.accum_count = 0
        self.last_vp: np.ndarray | None = None
        self._frame_dirty = False
        self.create_output_resource(width, height)
        self._camera_params = None

    # -- resources ---------------------------------------------------------- #
    def create_output_resource(self, width: int, height: int) -> None:
        super().create_output_resource(width, height)
        self.accum = jnp.zeros((height, width, 3), jnp.float32)
        self.accum_count = 0
        self.last_vp = None

    # -- per-frame ----------------------------------------------------------- #
    def mark_dirty(self) -> None:
        """UI parameter change -> restart accumulation (parity with the
        frameDirty reset, ProgressiveRaytracingPipeline.cpp:309-311)."""
        self._frame_dirty = True

    def update(self, elapsed_time: float, elapsed_frames: int) -> None:
        if self.animation_paused:
            elapsed_time = 142.0  # reference freeze point (:179-181)

        if (
            has_camera_moved(self.camera, self.last_vp)
            or not self.frame_accumulation_enabled
            or self._frame_dirty
        ):
            self.accum_count = 0
            self.last_vp = self.camera.view_proj_matrix()
            self._frame_dirty = False

        s_count = self.samples_per_frame
        if s_count == 1:
            self._camera_params = self._frame_camera_params(
                elapsed_frames, self.accum_count, self.rng
            )
        else:
            cams = [
                self._frame_camera_params(
                    elapsed_frames * s_count + k, self.accum_count, self.rng
                )
                for k in range(s_count)
            ]
            self._camera_params = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
        self.accum_count += s_count

        # Animated sun + default point light (:197-208) — only when the
        # pipeline owns the light rig (scene didn't define one).
        if self.scene_data is not None and getattr(self, "owns_lights", False):
            lights = default_lights(elapsed_time)
            self.scene_data = dict(self.scene_data, lights=lights)

    def set_instance_transforms(self, transforms) -> None:
        """Animate instance transforms via TLAS refit (two-level scenes
        only): O(instances) device work per frame, no geometry re-bake, no
        recompile — the D3D12 update-build path
        (/root/reference/Helpers/TopLevelASGenerator.cpp with
        PERFORM_UPDATE). Restarts accumulation (the scene changed)."""
        from ..scene.dynamic import refit_scene_instances

        if "tlas" not in self.scene_data:
            raise ValueError("set_instance_transforms needs a two-level scene "
                             "(Scene.build_two_level)")
        self.scene_data = refit_scene_instances(self.scene_data, transforms)
        self.mark_dirty()

    def _step_fn(self):
        # Geometry, lights and env are arguments of the compiled step, so it
        # is rebuilt only for a new static configuration (the env kind is
        # static); new geometry of the same structure (a TLAS refit, a
        # material edit) reuses it.
        cfg = (self.width, self.height, self.ao_only, self.samples_per_frame,
               getattr(self, "refraction", False),
               int(self.scene_data["env"]["kind"]))
        if getattr(self, "_step_cfg", None) != cfg:
            self._step = make_progressive_step(
                self.scene_data,
                self.width,
                self.height,
                self.ao_only,
                samples_per_step=self.samples_per_frame,
                refraction=cfg[4],
            )
            self._step_cfg = cfg
        return self._step

    def render(self) -> jnp.ndarray:
        self.accum = self._step_fn()(
            self.accum,
            self.options,
            self._camera_params,
            self.scene_data["lights"],
            self.scene_data["env"],
            jnp.asarray(self.max_iterations, jnp.int32),
            geo_arg=scene_geometry(self.scene_data),
        )
        return self.accum

    def get_output(self, index: int = 0) -> jnp.ndarray:
        return self.accum

    # -- checkpoint/resume ---------------------------------------------------- #
    def state_dict(self) -> dict:
        return {
            "accum": np.asarray(self.accum),
            "accum_count": self.accum_count,
            "last_vp": self.last_vp,
        }

    def load_state_dict(self, state: dict) -> None:
        self.accum = jnp.asarray(state["accum"])
        self.accum_count = int(state["accum_count"])
        self.last_vp = state["last_vp"]

    def save_checkpoint(self, path: str, frames_done: int | None = None) -> None:
        """Persist the restartable accumulation state — the reference's
        implicit (accum texture, accumCount) progress made durable
        (SURVEY.md §5 checkpoint/resume; the device-lost-recovery analogue,
        /root/reference/src/utils/DeviceResources.cpp:447-487).

        Also records the host RNG state and (optionally) the frame index,
        so a resumed render draws the SAME jitter sequence the
        uninterrupted run would — the continuation is bit-identical."""
        import json

        s = self.state_dict()
        rng_state = json.dumps(self.rng.bit_generator.state).encode()
        np.savez(
            path,
            accum=s["accum"],
            accum_count=np.asarray(s["accum_count"]),
            last_vp=s["last_vp"] if s["last_vp"] is not None else np.zeros((0,)),
            rng_state=np.frombuffer(rng_state, dtype=np.uint8),
            frames_done=np.asarray(-1 if frames_done is None else frames_done),
        )

    def load_checkpoint(self, path: str) -> int | None:
        """Restore a save_checkpoint file. Returns the recorded frame index
        (None for checkpoints without one) so CLI loops can continue at the
        exact frame the save happened."""
        import json

        z = np.load(path if path.endswith(".npz") else path + ".npz")
        self.load_state_dict(
            {
                "accum": z["accum"],
                "accum_count": int(z["accum_count"]),
                "last_vp": z["last_vp"] if z["last_vp"].size else None,
            }
        )
        if "rng_state" in z.files:
            self.rng.bit_generator.state = json.loads(
                z["rng_state"].tobytes().decode()
            )
        if "frames_done" in z.files and int(z["frames_done"]) >= 0:
            return int(z["frames_done"])
        return None

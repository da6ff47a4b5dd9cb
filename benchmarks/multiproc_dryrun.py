"""Two-process multi-HOST dryrun (VERDICT r3 #5).

The single-process dryruns (__graft_entry__.dryrun_multichip) validate the
mesh/sharding program on 8 virtual devices inside ONE process; this script
exercises the multi-host path SURVEY.md §5 claims ("DCN only for multi-host
render farms"): two OS processes, each owning 4 virtual CPU devices, joined
through ``jax.distributed`` (Gloo transport standing in for DCN), running
the GSPMD/shard_map progressive step over the global 8-device mesh — with
the "tile" axis spanning the process boundary so the accumulation
collectives actually cross it — and asserting the sharded result equals the
single-process render to 1e-5 (the cross-process psum's reduction order
differs from jnp.mean in the last float32 ulp — measured max 2.4e-6 — the
same tolerance the single-process equivalence tests use).

Launcher (spawns the two workers, checks both report OK):
    python benchmarks/multiproc_dryrun.py
Worker (internal):
    python benchmarks/multiproc_dryrun.py --worker IDX --port P
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 2
LOCAL_DEVICES = 4
W, H, SPP = 32, 32, 2
MARKER = "MULTIPROC_DRYRUN_OK"


def worker(idx: int, port: int) -> None:
    # env was prepared by the launcher; re-assert the platform after import
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=N_PROCS,
        process_id=idx,
    )
    assert jax.process_count() == N_PROCS
    assert len(jax.devices()) == N_PROCS * LOCAL_DEVICES

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, REPO)
    from dxrexperiments_tpu.app.headless import build_scene
    from dxrexperiments_tpu.core.camera import camera_params
    from dxrexperiments_tpu.models.progressive import make_progressive_step
    from dxrexperiments_tpu.parallel import (
        make_render_mesh,
        make_sharded_progressive_step,
        stack_cameras,
    )
    from dxrexperiments_tpu.trace.integrator import default_options

    # tile=4 x spp=2 over devices [0..7] laid out (4, 2): tiles {0,1} live
    # on process 0 and {2,3} on process 1 -> the row-sharded accumulation
    # and the spp psum-mean both execute with cross-process participants.
    n_tile, n_spp = 4, 2
    mesh = make_render_mesh(n_tile=n_tile, n_spp=n_spp)
    scene, cam = build_scene("cornell-glossy")
    cam.set_aspect(W, H)
    sd = scene.build()
    step = make_sharded_progressive_step(sd, W, H, mesh, samples_per_step=n_spp)

    def replicated(x):
        return multihost_utils.host_local_array_to_global_array(x, mesh, P())

    rng = np.random.default_rng(0)  # same stream on both processes
    cams = stack_cameras([
        camera_params(
            cam,
            jitter=((rng.random() - 0.5) / W, (rng.random() - 0.5) / H),
            frame_count=k,
            accum_count=0,
        )
        for k in range(n_spp)
    ])

    accum = jax.make_array_from_callback(
        (H, W, 3),
        NamedSharding(mesh, P("tile", None, None)),
        lambda ix: np.zeros((H, W, 3), np.float32)[ix],
    )
    args = jax.tree.map(
        replicated,
        (default_options(), cams, sd["lights"], sd["env"],
         jnp.asarray(8, jnp.int32)),
    )
    out = step(accum, *args)
    # this process's row block (tiles it owns), then the re-assembled
    # global image via one cross-process allgather
    local = multihost_utils.global_array_to_host_local_array(
        out, mesh, P("tile", None, None)
    )
    full = multihost_utils.process_allgather(np.asarray(local), tiled=True)

    # single-process oracle: the same two samples through the single-chip
    # compiled step on this process's default device
    ref_step = make_progressive_step(sd, W, H, samples_per_step=n_spp)
    ref = np.asarray(ref_step(
        jnp.zeros((H, W, 3), jnp.float32), default_options(), cams,
        sd["lights"], sd["env"], jnp.asarray(8, jnp.int32),
    ))
    rows = H // N_PROCS
    np.testing.assert_allclose(
        np.asarray(local), ref[idx * rows : (idx + 1) * rows], atol=1e-5,
        err_msg=f"process {idx}: local row block != single-process",
    )
    np.testing.assert_allclose(
        full, ref, atol=1e-5,
        err_msg=f"process {idx}: allgathered image != single-process",
    )
    print(f"{MARKER} proc={idx} mesh={n_tile}x{n_spp} "
          f"procs={jax.process_count()} devices={len(jax.devices())}",
          flush=True)


def main() -> int:
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), int(sys.argv[sys.argv.index("--port") + 1]))
        return 0

    port = int(os.environ.get("DXR_MP_PORT", "12367"))
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={LOCAL_DEVICES}",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--port", str(port)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(N_PROCS)
    ]
    ok = True
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        if p.returncode != 0 or MARKER not in out:
            ok = False
            print(f"worker {i} FAILED (rc={p.returncode}):\n{out}")
        else:
            print([l for l in out.splitlines() if MARKER in l][0])
    print("multiproc dryrun:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

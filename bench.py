"""Headline benchmark: primary-ray throughput on the Cornell box.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "Mrays/s", "card": "...", ...}

Matches the reference's runtime telemetry (w*h*fps primary MRays/s,
/root/reference/src/utils/DXSample.cpp:100-123) on BASELINE config 1
(Cornell box progressive, 512x512): the production step with 16 samples per
dispatch, timed fresh with a block_until_ready fence after compilation and
one warm-up dispatch; the best of 3 repetitions of 8 dispatches. Fails
without a GPU; the card's name and power limit go with the number.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WIDTH = HEIGHT = 512
SAMPLES_PER_DISPATCH = 16
DISPATCHES = 8
REPS = 3


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _cornell_setup
    from dxrexperiments_tpu.models.progressive import make_progressive_step
    from dxrexperiments_tpu.utils.runtime import (
        card_description, check_platform, enable_compile_cache,
    )

    check_platform("gpu", jax.devices())
    enable_compile_cache()

    scene, options, cams, accum0 = _cornell_setup(WIDTH, HEIGHT, 1)
    lights, env = scene["lights"], scene["env"]
    mi = jnp.asarray(1 << 30, jnp.int32)
    step = make_progressive_step(
        scene, WIDTH, HEIGHT, samples_per_step=SAMPLES_PER_DISPATCH
    )
    rng = np.random.default_rng(0)
    frames = []
    for f in range(DISPATCHES):
        cs = []
        for k in range(SAMPLES_PER_DISPATCH):
            c = dict(cams[0])
            c["jitter"] = jnp.asarray(
                [(rng.random() - 0.5) / WIDTH, (rng.random() - 0.5) / HEIGHT],
                jnp.float32,
            )
            c["frame_count"] = jnp.asarray(
                f * SAMPLES_PER_DISPATCH + k, jnp.uint32
            )
            c["accum_count"] = jnp.asarray(
                float(f * SAMPLES_PER_DISPATCH), jnp.float32
            )
            cs.append(c)
        frames.append(jax.tree.map(lambda *xs: jnp.stack(xs), *cs))

    jax.block_until_ready(  # compile + one warm-up dispatch
        step(accum0, options, frames[0], lights, env, mi)
    )
    dt = float("inf")
    for _ in range(REPS):
        accum = accum0
        t0 = time.perf_counter()
        for f in range(DISPATCHES):
            accum = step(accum, options, frames[f], lights, env, mi)
        jax.block_until_ready(accum)
        dt = min(dt, time.perf_counter() - t0)

    samples = DISPATCHES * SAMPLES_PER_DISPATCH
    print(json.dumps({
        "metric": "primary_mrays_per_sec_cornell512_progressive",
        "value": WIDTH * HEIGHT * samples / dt / 1e6,
        "unit": "Mrays/s",
        "ms_per_sample": dt / samples * 1e3,
        "card": card_description(),
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()

"""Checks that need a GPU (skipped on the CPU; see conftest.py for how to
run them on a card): the walk and brute force compiled for the card agree
with each other and with the CPU, and the production progressive step on
the card matches its CPU run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dxrexperiments_tpu.accel import traverse
from dxrexperiments_tpu.ops import intersect
from dxrexperiments_tpu.scene import Scene
from dxrexperiments_tpu.scene.procedural import random_triangle_soup

pytestmark = pytest.mark.gpu


def test_walk_on_card_matches_brute_and_cpu(gpu):
    sc = Scene()
    sc.add_model(random_triangle_soup(20000, seed=2, extent=10.0))
    scene = sc.build(accel="bvh")
    rs = np.random.default_rng(3)
    o = rs.uniform(-14, 14, (4096, 3)).astype(np.float32)
    d = -o + rs.normal(scale=2.0, size=o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cpu = jax.devices("cpu")[0]
    on = {dev: jax.device_put((scene, jnp.asarray(o), jnp.asarray(d)), dev)
          for dev in (gpu, cpu)}
    walk = {dev: traverse.closest(s["bvh"], oo, dd, 1e-4)
            for dev, (s, oo, dd) in on.items()}
    s, oo, dd = on[gpu]
    brute = intersect.intersect_closest(s, oo, dd, 1e-4)
    for ref in (brute, walk[cpu]):
        assert (np.asarray(walk[gpu]["tri"]) == np.asarray(ref["tri"])).mean() \
            >= 0.999
        hit = np.asarray(ref["hit"])
        np.testing.assert_allclose(np.asarray(walk[gpu]["t"])[hit],
                                   np.asarray(ref["t"])[hit], rtol=1e-5)


def test_progressive_step_on_card_matches_cpu(gpu):
    import chip_smoke

    sc, cam = chip_smoke._scene("cornell-glossy", 128, 128)
    batches = chip_smoke.progressive_cameras(cam, 128, 128, 4, 4)
    got = chip_smoke._accumulate(gpu, sc, 128, 128, batches, 4)
    want = chip_smoke._accumulate(jax.devices("cpu")[0], sc, 128, 128,
                                  batches, 4)
    mean_rel, bad = chip_smoke.image_agreement(got, want)
    assert mean_rel <= chip_smoke.IMAGE_MEAN_REL
    assert bad <= chip_smoke.PIXEL_FRAC

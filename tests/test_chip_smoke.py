"""chip_smoke.py on the CPU: its comparators and tolerance reporting, its
refusal to run without a GPU, and every phase rehearsed at a tiny size
(the CPU stands in for both the card and the reference device)."""

import jax
import numpy as np
import pytest

import chip_smoke as cs


def test_image_agreement():
    rs = np.random.default_rng(0)
    want = rs.uniform(0.1, 1.0, (10, 10, 3))
    assert cs.image_agreement(want, want) == (0.0, 0.0)
    got = want.copy()
    got[3, 4, 1] += 0.5  # one pixel moved visibly
    got[5, 5, 0] += 0.5 * cs.PIXEL_ABS  # one moved below the pixel limit
    mean_rel, bad = cs.image_agreement(got, want)
    assert bad == pytest.approx(0.01)
    assert mean_rel == pytest.approx(
        (0.5 + 0.5 * cs.PIXEL_ABS) / want.sum())
    with pytest.raises(cs.CheckFailed, match="non-finite"):
        cs.image_agreement(np.full_like(want, np.nan), want)
    with pytest.raises(cs.CheckFailed, match="shape"):
        cs.image_agreement(want[:5], want)


def test_hit_agreement():
    tri_ref = np.array([0, 1, 2, -1, 4])
    t_ref = np.array([1.0, 2.0, 4.0, -1.0, 8.0])
    tri = np.array([0, 1, 3, -1, 4])  # one tie resolved the other way
    t = t_ref * np.array([1.0, 1.0 + 1e-6, 1.0, 1.0, 1.0 - 2e-6])
    agree, err = cs.hit_agreement(tri, t, tri_ref, t_ref)
    assert agree == pytest.approx(0.8)
    assert err.size == 3  # rays that hit the same triangle
    assert err.max() == pytest.approx(2e-6)
    # with a floor, short distances are measured against the floor
    _, err = cs.hit_agreement(tri, t_ref + 1e-5, tri_ref, t_ref, t_floor=10.0)
    assert err.max() == pytest.approx(1e-6)


def test_checks_report_value_beside_limit(capsys):
    checks = cs.Checks("9")
    checks.at_most("small", 1e-6, 1e-5)
    checks.at_least("share", 0.99, 0.999)
    cs.check_occlusion(checks, "flags", [True, False], [True, False])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "  check 9 small: 1e-06 <= 1e-05 ok"
    assert out[1] == "  check 9 share: 0.99 >= 0.999 FAIL"
    assert out[2] == "  check 9 flags same occlusion: 1 >= 0.999 ok"
    with pytest.raises(cs.CheckFailed, match="failed share"):
        checks.done()
    cs.Checks("ok").done()  # nothing failed: no exception


def test_check_hits_two_level_share(capsys):
    checks = cs.Checks("4")
    n = 2000
    tri = np.arange(n)
    t = np.full(n, 50.0)
    t_got = t.copy()
    t_got[0] += 1.0  # one grazing ray far off: under 0.1% of the rays
    cs.check_hits(checks, "two-level", tri, t_got, tri, t, t_floor=1.0)
    checks.done()
    assert "largest 0.02" in capsys.readouterr().out
    strict = cs.Checks("3")
    cs.check_hits(strict, "walk", tri, t_got, tri, t)
    with pytest.raises(cs.CheckFailed):
        strict.done()


def test_refuses_to_run_without_gpu(capsys):
    assert cs.main([]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""  # no result printed
    assert "needs a GPU" in captured.err


PHASES = {
    "progressive": lambda d: cs.phase_progressive(
        d, d, size=16, spp=4, per_step=2, cpu_spp=2),
    "realtime": lambda d: cs.phase_realtime(
        d, d, width=32, height=16, k=3, batches=2),
    "bvh": lambda d: cs.phase_bvh(
        d, size=16, samples=2, n_rays=128, n_host=16,
        scene_name="instanced:5"),
    "two_level": lambda d: cs.phase_two_level(
        d, size=16, frames=3, n_rays=128, scene_name="instanced:5"),
    "cli": lambda d: cs.phase_cli(d, size=16, spp=2),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_rehearsal(phase, capsys):
    PHASES[phase](jax.devices()[0])
    out = capsys.readouterr().out
    assert "FAIL" not in out
    assert out.count(" ok") >= 4


@pytest.mark.parametrize("cull", [False, True])
def test_plain_mt_matches_scalar_oracle(cull):
    """The phase-3 reference intersector against the float64 scalar
    Möller–Trumbore, ray by ray over every triangle (chunks that do not
    divide the triangle count, so padding is exercised)."""
    rs = np.random.default_rng(1)
    n_tri, n_ray = 37, 64
    v0 = rs.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    e1 = rs.uniform(-0.6, 0.6, (n_tri, 3)).astype(np.float32)
    e2 = rs.uniform(-0.6, 0.6, (n_tri, 3)).astype(np.float32)
    o = rs.uniform(-3, 3, (n_ray, 3)).astype(np.float32)
    d = (rs.uniform(-1, 1, (n_ray, 3)) - o / 4).astype(np.float32)
    seg = rs.uniform(0.5, 4.0, n_ray).astype(np.float32)
    tri, occ = cs.plain_mt(v0, e1, e2, o, d, 1e-4, seg, cull, chunk=8)
    for r in range(n_ray):
        hits = []
        for k in range(n_tri):
            t = cs._scalar_mt(*(x.astype(np.float64) for x in
                                (v0[k], e1[k], e2[k], o[r], d[r])))
            if t is not None and t > 1e-4:
                front = np.dot(np.cross(d[r], e2[k]), e1[k]) > 0
                hits.append((t, k, front))
        closest = [h for h in hits if h[2] or not cull]
        assert tri[r] == (min(closest)[1] if closest else -1)
        assert occ[r] == any(t < seg[r] for t, _, _ in hits)
    assert (tri >= 0).any() and occ.any() and not occ.all()


def test_vec_mt64_matches_scalar():
    rs = np.random.default_rng(2)
    v0, e1, e2 = (rs.uniform(-1, 1, (20, 3)) for _ in range(3))
    o = rs.uniform(-3, 3, (20, 3))
    d = -o + rs.uniform(-0.2, 0.2, (20, 3))
    t = cs._vec_mt64(v0, e1, e2, o, d)
    for i in range(20):
        want = cs._scalar_mt(v0[i], e1[i], e2[i], o[i], d[i])
        if want is not None:
            assert t[i] == pytest.approx(want, rel=1e-12)


FOUR_CARDS = {
    "progressive": lambda devs: cs.four_card_progressive(
        devs, size=16, spp=8, per_step=4),
    "realtime": lambda devs: cs.four_card_realtime(
        devs, width=32, height=16, frames=3),
}


@pytest.mark.skipif(jax.device_count() < 4, reason="needs 4 virtual devices")
@pytest.mark.parametrize("path", sorted(FOUR_CARDS))
def test_four_card_rehearsal(path, capsys):
    """The --four-cards paths on four virtual CPU devices: shards land on
    distinct devices and agree with the one-device render."""
    FOUR_CARDS[path](jax.devices()[:4])
    out = capsys.readouterr().out
    assert "FAIL" not in out
    assert "shards on distinct devices: 4 >= 4 ok" in out

"""Fixed-shape batch serving (reference README.md:28-29 roadmap items)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_tpu.config import ViTConfig
from vit_tpu.models import vit
from vit_tpu.serving import Predictor

CFG = ViTConfig(image_size=32, patch_size=16, hidden_dim=48, num_heads=4,
                num_layers=2, mlp_dim=96)


@pytest.fixture(scope="module")
def pred():
    params = vit.init_params(jax.random.key(0), CFG)
    return Predictor(params, CFG, buckets=(1, 2, 4))


def test_plan_decomposition(pred):
    assert pred._plan(4) == [4]
    assert pred._plan(7) == [4, 2, 1]
    assert pred._plan(3) == [2, 1]
    assert pred._plan(5) == [4, 1]
    # tail that fits no exact bucket rounds up to the smallest that fits
    p = Predictor(pred.params, CFG, buckets=(4, 16))
    assert p._plan(3) == [4]
    assert p._plan(21) == [16, 4, 4]


@pytest.mark.parametrize("n", [1, 3, 5, 7])
def test_outputs_match_direct_forward(pred, n, rng):
    px = rng.standard_normal((n, 3, 32, 32)).astype(np.float32)
    got = np.asarray(pred(px))
    want = np.asarray(vit.forward(pred.params, jnp.asarray(px), CFG))
    assert got.shape == (n, CFG.seq_len, CFG.hidden_dim)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mesh_bucket_rounding(pred):
    from vit_tpu.parallel import make_mesh

    mesh = make_mesh(data=4, model=1)
    p = Predictor(pred.params, CFG, buckets=(1, 2, 4, 6), mesh=mesh)
    assert p.buckets == (4, 8)  # rounded up to multiples of data=4


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (1, 4)])
def test_mesh_serving_matches_single_device(pred, rng, data, model):
    """Sharded GSPMD forward must equal the single-device result —
    SURVEY.md §2.6's fan-out entry point."""
    from vit_tpu.parallel import make_mesh

    mesh = make_mesh(data=data, model=model)
    p = Predictor(pred.params, CFG, buckets=(8,), mesh=mesh)
    px = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    got = np.asarray(p(px))
    want = np.asarray(vit.forward(pred.params, jnp.asarray(px), CFG))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("data,model", [(4, 1), (2, 2)])
def test_mesh_multibucket_single_dispatch(pred, rng, data, model):
    """A multi-bucket request on a mesh runs through ONE jitted plan
    executor (the host's per-call cost is paid once per request, not once
    per chunk) and still matches the single-device forward."""
    from vit_tpu.parallel import make_mesh

    mesh = make_mesh(data=data, model=model)
    p = Predictor(pred.params, CFG, buckets=(4, 8), mesh=mesh)
    px = rng.standard_normal((14, 3, 32, 32)).astype(np.float32)
    got = np.asarray(p(px))  # plan [8, 4, 4(pad 2)] -> one executor
    assert list(p._plan_fns) == [(8, 4, 4)]
    want = np.asarray(vit.forward(pred.params, jnp.asarray(px), CFG))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_mesh_serving_quant_tp(pred, rng):
    """Int8 TENSOR parallelism: the quant pytree is Megatron-sharded over a
    4x2 mesh and served through GSPMD with the single-device answers."""
    from vit_tpu.parallel import make_mesh
    from vit_tpu.quant import forward_quant, quantize_params

    mesh = make_mesh(data=4, model=2)
    p = Predictor(pred.params, CFG, buckets=(8,), mesh=mesh, quant=True)
    px = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    got = np.asarray(p(px))
    want = np.asarray(forward_quant(quantize_params(pred.params),
                                    jnp.asarray(px), CFG))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_precompile_warms_the_request_executors(pred):
    # precompile builds the executor each single-bucket request uses.
    p = Predictor(pred.params, CFG, buckets=(1, 2), precompile=True)
    assert set(p._plan_fns) == {(1,), (2,)}


def test_padding_images_do_not_leak(pred, rng):
    # Same image must produce identical output whether padded or not.
    px = rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
    single = np.asarray(pred(px))
    padded_batch = np.asarray(pred(np.concatenate([px] * 3)))  # plan [2, 1]
    np.testing.assert_allclose(single[0], padded_batch[0], atol=1e-5)
    np.testing.assert_allclose(single[0], padded_batch[2], atol=1e-5)


def test_bench_serving_tiny(tmp_path):
    """The on-chip serving benchmark CLI runs end-to-end in tiny/CPU mode
    and writes the reference-layout artifact."""
    from vit_tpu.bench import serving as bench_serving

    bench_serving.main(["--tiny", "--dtype", "float32",
                        "--out-root", str(tmp_path)])
    assert (tmp_path / "serving" / "Performance.csv").exists()

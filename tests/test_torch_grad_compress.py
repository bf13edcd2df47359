"""The port's compressed cross-pod gradient reduction against the JAX
package's, on 2 gloo CPU ranks (one per pod, ``launch.mesh.spawn``).

The reference's own test (``tests/test_grad_compress.py``) cannot run
here: XLA's SPMD partitioner aborts on its partial-manual ``shard_map``.
So the reference side runs the reference's own functions under
``jax.vmap(..., axis_name="pod")``, which gives each pod its collective:

  * ``pod_mean_compressed`` for ``none``, ``bf16`` and ``int8`` on a 0-d
    grad, last dims that are not a multiple of 256, an all-zero block and
    a bf16 grad: equal to the reference's, bit for bit;
  * ``make_compressed_train_step`` on reduced internlm2-1.8b in f32, one
    step from the JAX init on 8 sequences (4 a pod): against the port's
    single-process step, the loss within 1e-5 and the params within the
    reference test's tolerances (none 1e-5, bf16 5e-3, int8 1e-2); against
    a ``vmap`` emulation of the reference's ``local_step`` (its
    ``model.loss``, ``pod_mean_compressed`` and ``adamw_update``) and the
    JAX single-device ``make_train_step``, the loss within 1e-5 and the
    params within those tolerances plus ``XPKG`` = 3e-5. ``XPKG`` is what
    one plain f32 step of the two packages may part by from one init
    (``test_plain_steps_part_by_less_than_xpkg``; 1.54e-5 measured): at a
    weight whose gradient is near Adam's eps (1e-8) the first update,
    lr * g / (|g| + eps), turns on the gradient's last bits, which the two
    frameworks' f32 sums round differently.

The ranks import this module to find their functions, so JAX and the
reference package are imported only inside the tests that use them: a
rank starts without them.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ckpt.layout import host_array
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_to_numpy, state_from_jax
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_test_mesh, spawn
from repro_torch.models.model import build_model
from repro_torch.train.grad_compress import (make_compressed_train_step,
                                             payload_bytes,
                                             pod_mean_compressed)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import leaves_with_path

CODECS = ("none", "bf16", "int8")
# (shape, dtype): a 0-d grad, last dims off the 256-block grid, a block
# of zeros (rows 0 of the (2, 512) case), a bf16 grad
SHAPES = [((), "float32"), ((7,), "float32"), ((3, 300), "float32"),
          ((2, 512), "float32"), ((2, 3, 257), "float32"),
          ((3, 300), "bfloat16")]
TOL = {"none": 1e-5, "bf16": 5e-3, "int8": 1e-2}
XPKG = 3e-5
RANK_TIMEOUT = 240


def _grad(pod, i):
    shape, dtype = SHAPES[i]
    g = np.asarray(np.random.default_rng(100 * pod + i).standard_normal(shape)
                   * (1 + 10 * i), np.float32)
    if shape == (2, 512):
        g[0, :256] = 0.0
    return g, dtype


def _torch(g, dtype):
    t = torch.from_numpy(g.copy())
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _pod_mean_rank(rank, world):
    mesh = make_test_mesh((world,), ("pod",), "cpu")
    group = mesh.get_group("pod")
    out = {}
    for codec in CODECS:
        for i in range(len(SHAPES)):
            g, dtype = _grad(rank, i)
            r = pod_mean_compressed(_torch(g, dtype), codec, group)
            out[codec, i] = (host_array(r), str(r.dtype), tuple(r.shape))
    return out


@pytest.fixture(scope="module")
def port_pod_means():
    return spawn(_pod_mean_rank, 2, timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("i", range(len(SHAPES)))
@pytest.mark.parametrize("codec", CODECS)
def test_pod_mean_matches_reference(codec, i, port_pod_means):
    import jax
    import jax.numpy as jnp
    from repro.train.grad_compress import pod_mean_compressed as jpod_mean
    shape, dtype = SHAPES[i]
    pods = np.stack([_grad(p, i)[0] for p in range(2)])
    x = jnp.asarray(pods, dtype)
    want = jax.vmap(lambda g: jpod_mean(g, codec), axis_name="pod")(x)
    want = np.asarray(want)
    assert np.array_equal(want[0], want[1])
    for rank in range(2):
        got, got_dtype, got_shape = port_pod_means[rank][codec, i]
        assert got_shape == shape and got_dtype == f"torch.{dtype}"
        ref = want[0].view(np.int16) if dtype == "bfloat16" else want[0]
        assert np.array_equal(got, ref), (codec, shape, dtype)


def test_payload_bytes():
    g = torch.zeros(3, 300)
    assert payload_bytes(g, "none") == 3600
    assert payload_bytes(g, "bf16") == 1800
    assert payload_bytes(g, "int8") == 3 * 2 * (256 + 4)
    assert payload_bytes(torch.zeros(()), "int8") == 260


def _step_rank(rank, world, np_state):
    cfg = dataclasses.replace(treduced(tget_config("internlm2-1.8b")),
                              dtype="float32")
    model = build_model(cfg)
    mesh = make_test_mesh((world,), ("pod",), "cpu")
    opt = AdamWConfig(warmup_steps=1, total_steps=4)
    batch = TokenPipeline(cfg, 8, 32, seed=0).next("cpu")
    state, m = make_train_step(model, opt)(state_from_jax(np_state, "cpu"),
                                           batch)
    out = {"single": (float(m["loss"]), params_to_numpy(state["params"]))}
    for codec in CODECS:
        step = make_compressed_train_step(model, opt, mesh, codec=codec)
        state, m = step(state_from_jax(np_state, "cpu"), batch)
        out[codec] = (float(m["loss"]), params_to_numpy(state["params"]))
    return out


@pytest.fixture(scope="module")
def steps():
    """(port results per rank, vmap emulation per codec, single-device
    step) from one JAX init."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduced
    from repro.data.pipeline import TokenPipeline as JPipeline
    from repro.models import build_model as jbuild
    from repro.train import AdamWConfig as JAdamW
    from repro.train import init_state, make_train_step as jmake_train_step
    from repro.train.grad_compress import pod_mean_compressed as jpod_mean
    from repro.train.optimizer import adamw_update as jadamw_update
    jcfg = dataclasses.replace(reduced(get_config("internlm2-1.8b")),
                               dtype="float32")
    model = jbuild(jcfg)
    opt = JAdamW(warmup_steps=1, total_steps=4)
    batch = {k: jnp.asarray(v)
             for k, v in JPipeline(jcfg, 8, 32, seed=0).next().items()}
    state0 = init_state(model, jax.random.PRNGKey(0))
    single, m1 = jax.jit(jmake_train_step(model, opt))(state0, batch)

    def emulate(codec):
        def local_step(state, b):
            (loss, aux), grads = jax.value_and_grad(
                lambda p: model.loss(p, b, remat=True),
                has_aux=True)(state["params"])
            grads = jax.tree.map(lambda g: jpod_mean(g, codec), grads)
            params, opt_state, om = jadamw_update(
                opt, grads, state["opt_state"], state["params"])
            return params, jax.lax.pmean(loss, "pod")
        pods = {k: v.reshape(2, v.shape[0] // 2, *v.shape[1:])
                for k, v in batch.items()}
        params, loss = jax.jit(jax.vmap(local_step, in_axes=(None, 0),
                                        axis_name="pod"))(state0, pods)
        return (float(loss[0]),
                jax.tree.map(lambda a: np.asarray(a[0]), params))

    ref = {c: emulate(c) for c in CODECS}
    port = spawn(_step_rank, 2, jax.device_get(state0),
                 timeout=RANK_TIMEOUT)
    return port, ref, (float(m1["loss"]), jax.device_get(single["params"]))


def _tree_delta(a, b):
    a, b = dict(leaves_with_path(a)), dict(leaves_with_path(b))
    assert sorted(a) == sorted(b)
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


def _delta(jtree, tree):
    import jax
    want = dict((tuple(k.key for k in p), np.asarray(a, np.float32))
                for p, a in jax.tree_util.tree_flatten_with_path(jtree)[0])
    got = dict(leaves_with_path(tree))
    assert sorted(want) == sorted(got)
    return max(float(np.max(np.abs(want[k] - got[k].astype(np.float32))))
               for k in want)


def test_plain_steps_part_by_less_than_xpkg(steps):
    port, _, (loss1, params1) = steps
    loss, params = port[0]["single"]
    assert abs(loss - loss1) < 1e-5
    assert _delta(params1, params) < XPKG


@pytest.mark.parametrize("codec", CODECS)
def test_compressed_step_matches_reference(codec, steps):
    port, ref, (loss1, params1) = steps
    single_loss, single = port[0]["single"]
    for rank in range(2):
        loss, params = port[rank][codec]
        assert loss == port[0][codec][0]
        # against the port's single-process step: the reference test's
        assert abs(loss - single_loss) < 1e-5, (loss, single_loss)
        assert _tree_delta(single, params) < TOL[codec], codec
        # against the vmap emulation of the reference's local_step
        assert abs(loss - ref[codec][0]) < 1e-5, (loss, ref[codec][0])
        assert _delta(ref[codec][1], params) < TOL[codec] + XPKG, codec
        # against the reference's single-device step
        assert abs(loss - loss1) < 1e-5, (loss, loss1)
        assert _delta(params1, params) < TOL[codec] + XPKG, codec

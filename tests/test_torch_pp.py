"""The port's pipeline parallelism (``horovod_tpu_torch.parallel.
pipeline_apply`` and ``models.parallel_lm``'s ``stack_layers``,
``lm_pp_specs``, ``lm_apply_pp`` and ``pp_reduce_rest_grads``) in a
4-rank gloo world, against the JAX package under ``shard_map``.

The world (started once for the module on ``tests/test_torch_tp.py``'s
``start_world``) runs every case over a ``pp=4`` mesh and saves each
rank's results; the JAX side runs in this process on tests/conftest.py's
8-device virtual CPU mesh with the same numpy inputs. Rank ``r`` holds
stage ``r``, the ``[1, ...]`` slice of the stacked weights.

* ``pipeline_apply`` (tests/test_parallel.py's ``TestPipeline``: 4
  stages ``tanh(a @ W + b)``, 6 microbatches of 2 rows): the forward
  against the JAX pipeline and the sequential product (atol 1e-5), each
  stage's gradients against the JAX gradients (rtol 1e-5 / atol 1e-6),
  and ``remat`` against the stored schedule (rtol 1e-6 / atol 1e-7);
* ``lm_apply_pp`` (tests/test_parallel_lm.py's pins: 4 layers, one a
  stage, 2 microbatches, ``remat`` off and on): the loss against the JAX
  step (rtol 1e-5) and every gradient, the stage's and the
  ``pp_reduce_rest_grads`` ones, against the JAX step's (rtol 3e-4 /
  atol 3e-5); the batch and stack-length ``ValueError`` s on every rank;
* ``stack_layers`` and ``lm_pp_specs`` against the JAX functions, and a
  ``pp=1`` mesh (no process group) as the dense ``lm_apply``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu import parallel as jpar
from horovod_tpu.models import parallel_lm as jplm
from horovod_tpu_torch.models import parallel_lm as tplm
from test_torch_tp import _leaves, _np_tree, start_world

N = 4
PIPE_TOL = dict(atol=1e-5)
PIPE_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
REMAT_TOL = dict(rtol=1e-6, atol=1e-7)
LM_GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
# The pipeline's stages: D 8, 6 microbatches of 2 rows.
D, M, BM = 8, 6, 2
# tests/test_parallel_lm.py's LM at 4 layers: 4 heads of 8, MLP 32,
# vocab 64, 64 positions; a batch of 4 x 16 tokens in 2 microbatches.
V, LMAX, LAYERS, H, DH, FFN = 64, 64, 4, 4, 8, 32
B, L, MICRO = 4, 16, 2


def _stages():
    rng = np.random.default_rng(51)
    ws = (0.3 * rng.standard_normal((N, D, D))).astype(np.float32)
    bs = (0.1 * rng.standard_normal((N, D))).astype(np.float32)
    x = rng.standard_normal((M, BM, D)).astype(np.float32)
    return ws, bs, x


def _lm_params():
    """The LM's dense weights from a numpy seed, in the JAX pytree's
    layout (``normal / sqrt(fan_in)``, LayerNorm gains about one)."""
    rng = np.random.default_rng(52)
    e = H * DH

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def ln():
        return {"g": (1 + 0.1 * rng.standard_normal(e)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(e)).astype(np.float32)}

    return {
        "embed": dense((V, e), e), "pos": dense((LMAX, e), e),
        "layers": [{"ln1": ln(), "wqkv": dense((e, 3, H, DH), e),
                    "wo": dense((H, DH, e), e), "bo": dense((e,), e),
                    "ln2": ln(), "wup": dense((e, FFN), e),
                    "bup": dense((FFN,), e), "wdn": dense((FFN, e), FFN),
                    "bdn": dense((e,), FFN)} for _ in range(LAYERS)],
        "ln_f": ln(), "head": dense((e, V), e),
    }


def _tokens(batch=B):
    return np.random.default_rng(53).integers(0, V, (batch, L)).astype(
        np.int32)


# ---------------------------------------------------------- the ranks


def _stage(params, a):
    w, b = params
    return torch.tanh(a @ w + b)


def _pipeline_cases(rank):
    from horovod_tpu_torch.parallel import pipeline_apply

    ws, bs, x = _stages()
    res = {}
    for remat in (False, True):
        w = torch.tensor(ws[rank:rank + 1], requires_grad=True)
        b = torch.tensor(bs[rank:rank + 1], requires_grad=True)
        out = pipeline_apply(_stage, (w, b), torch.tensor(x), "pp",
                             remat=remat)
        (out ** 2).mean().backward()
        res[remat] = (out.detach().numpy(), w.grad.numpy(), b.grad.numpy())
    return res


def _lm_pp_step(rank, remat):
    rest, stacked = tplm.stack_layers(
        tplm.params_from_numpy(_lm_params(), device="cpu"))
    rspec, lspec = tplm.lm_pp_specs(rest, stacked)
    rest = tplm.shard_lm_params(rest, rspec, N, rank)
    stage = tplm.shard_lm_params(stacked, lspec, N, rank)
    for t in _leaves(rest) + _leaves(stage):
        t.requires_grad_(True)
    toks = torch.tensor(_tokens(), dtype=torch.long)
    loss = tplm.next_token_nll(tplm.lm_apply_pp(
        rest, stage, toks, axis="pp", microbatches=MICRO, remat=remat),
        toks)
    loss.backward()

    def grads(t):
        if isinstance(t, dict):
            return {k: grads(v) for k, v in t.items()}
        return t.grad
    return (float(loss), _np_tree(tplm.pp_reduce_rest_grads(grads(rest))),
            _np_tree(grads(stage)), stage["wqkv"].shape)


def _errors(rank):
    """The two ``ValueError`` s of ``lm_apply_pp`` (their messages)."""
    rest, stacked = tplm.stack_layers(
        tplm.params_from_numpy(_lm_params(), device="cpu"))
    stage = tplm.shard_lm_params(stacked, tplm.lm_pp_specs(rest, stacked)[1],
                                 N, rank)
    toks = torch.tensor(_tokens(6), dtype=torch.long)
    out = []
    for st, t, micro in ((stage, toks, 4), (stacked, toks[:4], 2)):
        try:
            tplm.lm_apply_pp(rest, st, t, microbatches=micro)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _worker(rank, n, init, out):
    """One rank of the ``pp=4`` gloo world: every case, results saved."""
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.logical import LogicalMesh, bind

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=n)
    with bind(LogicalMesh.from_config(f"pp={n}")):
        res = {"pipeline": _pipeline_cases(rank),
               "lm": {remat: _lm_pp_step(rank, remat)
                      for remat in (False, True)},
               "errors": _errors(rank)}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return start_world(N, str(tmp_path_factory.mktemp("pp")),
                       "test_torch_pp")


# --------------------------------------------------------- the JAX side


def _jrun(fn, in_specs, out_specs, *args):
    mesh = jpar.make_mesh({"pp": N}, devices=jax.devices()[:N])
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))(*args)


def _jstage(params, a):
    w, b = params
    return jnp.tanh(a @ w + b)


# -------------------------------------------------------- the pipeline


def test_pipeline_forward_matches_jax_and_sequential(world):
    ws, bs, x = _stages()
    want = np.asarray(_jrun(
        lambda p, xx: jpar.pipeline_apply(_jstage, p, xx, "pp"),
        ((P("pp"), P("pp")), P()), P(), (ws, bs), x))
    seq = x
    for p in range(N):
        seq = np.tanh(seq @ ws[p] + bs[p])
    np.testing.assert_allclose(want, seq, **PIPE_TOL)
    for res in world:
        np.testing.assert_allclose(res["pipeline"][False][0], want,
                                   **PIPE_TOL)


def test_pipeline_gradients_match_jax(world):
    """Each stage's gradients of ``mean(out ** 2)``, taken on every rank
    over the replicated output, equal the JAX gradients: the final
    masked sum's identity backward scales nothing by the stage count."""
    ws, bs, x = _stages()

    def region(p, xx):
        return jax.grad(lambda p: jnp.mean(
            jpar.pipeline_apply(_jstage, p, xx, "pp") ** 2))(p)

    gw, gb = (np.asarray(g) for g in _jrun(
        region, ((P("pp"), P("pp")), P()), (P("pp"), P("pp")), (ws, bs),
        x))
    for r, res in enumerate(world):
        _, w, b = res["pipeline"][False]
        np.testing.assert_allclose(w, gw[r:r + 1], **PIPE_GRAD_TOL)
        np.testing.assert_allclose(b, gb[r:r + 1], **PIPE_GRAD_TOL)


def test_pipeline_remat_matches_the_stored_schedule(world):
    for res in world:
        for a, b in zip(res["pipeline"][False], res["pipeline"][True]):
            np.testing.assert_allclose(b, a, **REMAT_TOL)


# -------------------------------------------------------------- the LM


def _jax_lm_pp():
    """The JAX ``lm_apply_pp`` step: loss, the reduced rest gradients and
    the stacked layer gradients (tests/test_parallel_lm.py's region)."""
    params = jax.tree_util.tree_map(jnp.asarray, _lm_params())
    rest, stacked = jplm.stack_layers(params)
    rest_spec, layer_spec = jplm.lm_pp_specs(rest, stacked)
    tokens = jnp.asarray(_tokens())

    def region(rest, stacked, t):
        def loss_fn(rest, stacked):
            return jplm.next_token_nll(jplm.lm_apply_pp(
                rest, stacked, t, axis="pp", microbatches=MICRO), t)
        loss, (g_rest, g_layers) = jax.value_and_grad(
            loss_fn, argnums=(0, 1))(rest, stacked)
        return loss, jplm.pp_reduce_rest_grads(g_rest), g_layers

    loss, g_rest, g_layers = _jrun(
        region, (rest_spec, layer_spec, P()),
        (P(), rest_spec, layer_spec), rest, stacked, tokens)
    tree = jax.tree_util.tree_map(np.asarray, (g_rest, g_layers))
    return float(loss), tree[0], tree[1]


@pytest.mark.parametrize("remat", [False, True], ids=["stored", "remat"])
def test_lm_apply_pp_step_matches_jax(world, remat):
    jloss, jrest, jlayers = _jax_lm_pp()
    dense = tplm.params_from_numpy(_lm_params(), device="cpu")
    toks = torch.tensor(_tokens(), dtype=torch.long)
    with torch.no_grad():
        dloss = float(tplm.next_token_nll(tplm.lm_apply(dense, toks), toks))
    np.testing.assert_allclose(dloss, jloss, rtol=1e-5)
    for r, res in enumerate(world):
        loss, g_rest, g_stage, shape = res["lm"][remat]
        assert tuple(shape) == (1, H * DH, 3, H, DH)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        for got, want in zip(_leaves(g_rest), _leaves(jrest)):
            np.testing.assert_allclose(got, want, **LM_GRAD_TOL)
        for got, want in zip(_leaves(g_stage), _leaves(jlayers)):
            np.testing.assert_allclose(got, want[r:r + 1], **LM_GRAD_TOL)


def test_lm_apply_pp_shape_errors(world):
    """The batch must split into the microbatches, and each rank must
    hold one stage (the JAX function's two errors)."""
    for res in world:
        micro, stack = res["errors"]
        assert micro is not None and "microbatches=4" in micro
        assert stack is not None and "leading dim is 4" in stack \
            and "'pp' axis size (4)" in stack


# ------------------------------------------- stacking and the specs


def test_stack_layers_and_specs_match_jax():
    params = _lm_params()
    jrest, jstacked = jplm.stack_layers(
        jax.tree_util.tree_map(jnp.asarray, params))
    rest, stacked = tplm.stack_layers(
        tplm.params_from_numpy(params, device="cpu"))
    assert sorted(rest) == sorted(jrest)
    for got, want in zip(_leaves(_np_tree(stacked)),
                         _leaves(jax.tree_util.tree_map(np.asarray,
                                                        jstacked))):
        np.testing.assert_array_equal(got, want)
    jrs, jls = jplm.lm_pp_specs(jrest, jstacked)
    rs, ls = tplm.lm_pp_specs(rest, stacked)
    is_p = lambda x: isinstance(x, P)  # noqa: E731
    assert [tuple(s) for s in jax.tree_util.tree_leaves(jrs, is_leaf=is_p)] \
        == [s for s in jax.tree_util.tree_leaves(
            rs, is_leaf=lambda x: isinstance(x, tuple))]
    assert [tuple(s) for s in jax.tree_util.tree_leaves(jls, is_leaf=is_p)] \
        == [s for s in jax.tree_util.tree_leaves(
            ls, is_leaf=lambda x: isinstance(x, tuple))]
    for r in range(N):
        stage = tplm.shard_lm_params(stacked, ls, N, r)
        for got, full in zip(_leaves(stage), _leaves(stacked)):
            np.testing.assert_array_equal(got.numpy(),
                                          full[r:r + 1].numpy())


def test_pp_axis_of_one_is_the_dense_lm():
    """A ``pp=1`` mesh runs no collective (no process group): one stage
    holding the one layer is ``lm_apply``, and ``pp_reduce_rest_grads``
    leaves the gradients as they are."""
    from horovod_tpu_torch.parallel import LogicalMesh, bind

    params = _lm_params()
    params["layers"] = params["layers"][:1]
    dense = tplm.params_from_numpy(params, device="cpu")
    rest, stacked = tplm.stack_layers(dense)
    toks = torch.tensor(_tokens(), dtype=torch.long)
    with bind(LogicalMesh.from_config("pp=1")), torch.no_grad():
        got = tplm.lm_apply_pp(rest, stacked, toks, microbatches=MICRO)
        same = tplm.pp_reduce_rest_grads(rest)
        want = tplm.lm_apply(dense, toks)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert all(same[k] is rest[k] for k in rest)

"""Loss and optimizer: the port against the JAX package's losses and its
optax AdamW with per-epoch learning-rate decay.

Tolerances: the weighted cross-entropies within 1e-6 (float32 reductions in
another order); after 3 AdamW steps across 2 epochs (learning rate set from
the epoch counter), parameters and both moments within 1e-6 of optax's, and
the port's optimizer state written as optax's flatten-order leaves matches
optax's own leaves in order, shape and dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gnn_tumor_seg_tpu.models.sage import GraphSage as JaxGraphSage
from gnn_tumor_seg_tpu.train.losses import weighted_cross_entropy as jax_wce
from gnn_tumor_seg_tpu.train.losses import (
    weighted_cross_entropy_per_graph as jax_wce_per_graph)
from gnn_tumor_seg_tpu.train.optim import apply_updates, make_train_state
from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.convert import gnn_params_from_jax
from gnn_tumor_seg_tpu_torch.train.losses import (
    weighted_cross_entropy, weighted_cross_entropy_per_graph)
from gnn_tumor_seg_tpu_torch.train.optim import (epoch_lr, load_opt_state_leaves,
                                                 make_optimizer, opt_state_leaves,
                                                 set_lr)


def test_weighted_cross_entropies_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 40, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (3, 40)).astype(np.int32)
    labels[:, 30:] = -1                                  # padded nodes
    mask = (rng.random((3, 40)) > 0.2).astype(np.float32)
    mask[2] = 0.0                                        # a padding graph
    w = np.asarray([0.1, 1, 2, 2], np.float32)
    args_j = (jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w),
              jnp.asarray(mask))
    args_t = (torch.from_numpy(logits), torch.from_numpy(labels),
              torch.from_numpy(w), torch.from_numpy(mask))
    np.testing.assert_allclose(weighted_cross_entropy(*args_t).item(),
                               float(jax_wce(*args_j)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(weighted_cross_entropy_per_graph(*args_t).numpy(),
                               np.asarray(jax_wce_per_graph(*args_j)),
                               rtol=1e-6, atol=1e-6)
    assert weighted_cross_entropy_per_graph(*args_t)[2].item() == 0.0


def test_adamw_with_epoch_decay_matches_optax():
    hp = HyperParams(layer_sizes=[8], lr=1e-2, lr_decay=0.9, w_decay=1e-2)
    jparams = JaxGraphSage(5, hp.layer_sizes, 4, "pool").init(jax.random.PRNGKey(0))
    state, tx = make_train_state(jparams, hp.lr, hp.lr_decay, hp.w_decay)
    update = jax.jit(lambda st, g: apply_updates(tx, st, g))
    model = gnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    params = model.jax_parameters()
    opt = make_optimizer(params, hp)
    rng = np.random.default_rng(1)
    for epoch, n_steps in ((0, 2), (1, 1)):
        set_lr(opt, epoch_lr(hp.lr, hp.lr_decay, epoch))
        for _ in range(n_steps):
            grads = [rng.normal(size=p.shape).astype(np.float32) for p in params]
            state = update(state, jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(state.params),
                [jnp.asarray(g) for g in grads]))
            for p, g in zip(params, grads):
                p.grad = torch.from_numpy(g)
            opt.step()
        state = state.next_epoch()
    for p, want in zip(params, jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    want_leaves = jax.tree_util.tree_leaves(state.opt_state)
    got_leaves = opt_state_leaves(opt)
    assert len(got_leaves) == len(want_leaves) == 8 + 2 * len(params)
    for got, want in zip(got_leaves, want_leaves):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert int(got_leaves[0]) == int(got_leaves[7]) == 3

    # the moments and step count load back into a fresh optimizer unchanged
    fresh = make_optimizer([torch.nn.Parameter(p.detach().clone())
                            for p in params], hp)
    load_opt_state_leaves(fresh, got_leaves)
    for got, want in zip(opt_state_leaves(fresh)[7:], got_leaves[7:]):
        assert np.array_equal(got, want)

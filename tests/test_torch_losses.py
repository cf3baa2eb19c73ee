"""The port's losses and baselines against the JAX package's, on the CPU.

Inputs come from a seeded ``np.random.RandomState``; baseline weights
from the JAX ``init_params``, carried with the port's
``params_to_torch_state``. Every loss and its gradient with respect to the
probabilities (or scores) is held at 1e-6 in float32: the two frameworks
sum the same terms in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalgame_tpu.game import losses as jl
from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu_torch.game import losses as tl
from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.exchange import ExchangeOutputs
from multimodalgame_tpu_torch.game.train import losses_from_exchange
from multimodalgame_tpu_torch.models.baseline import Baseline
from multimodalgame_tpu_torch.utils.torch_interop import (
    load_torch_state, params_to_torch_state)

TOL = 1e-6
B, T, W, D = 6, 4, 5, 7


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


def _inputs(seed, batch=B, turns=None):
    """Bits, probabilities, rewards and baseline scores; with ``turns``
    each but the rewards is stacked over turns."""
    rng = np.random.RandomState(seed)
    lead = (batch,) if turns is None else (turns, batch)
    probs = rng.uniform(0.05, 0.95, lead + (W,)).astype(np.float32)
    feats = (rng.rand(*lead, W) < probs).astype(np.float32)
    logs = -rng.rand(batch, 1).astype(np.float32) * 3.0
    scores = rng.randn(*lead, 1).astype(np.float32)
    return feats, probs, logs, scores


def _row_mask(batch, rows, seed):
    m = np.zeros((batch, 1), np.float32)
    m[np.random.RandomState(seed).permutation(batch)[:rows]] = 1.0
    return m


def _turn_masks(seed, turns=T, batch=B):
    rng = np.random.RandomState(seed)
    m = np.minimum.accumulate((rng.rand(turns, batch, 1) < 0.7)
                              .astype(np.float32), axis=0)
    m[0] = 1.0
    return m


def test_loglikelihood_and_nll_match_jax():
    rng = np.random.RandomState(0)
    dist = np.log(np.random.RandomState(1).dirichlet(np.ones(D), B)
                  ).astype(np.float32)
    target = rng.randint(0, D, B)
    _close(tl.loglikelihood(torch.from_numpy(dist), torch.from_numpy(target)),
           jl.loglikelihood(jnp.asarray(dist), jnp.asarray(target)))
    d = torch.from_numpy(dist).requires_grad_()
    got = tl.nll_loss(d, torch.from_numpy(target))
    got.backward()
    want, grad = jax.value_and_grad(jl.nll_loss)(jnp.asarray(dist),
                                                  jnp.asarray(target))
    _close(got, want)
    _close(d.grad, grad)


@pytest.mark.parametrize("masked", [False, True])
def test_get_rec_outp_matches_jax(masked):
    rng = np.random.RandomState(2)
    y = rng.randn(T, B, D).astype(np.float32)
    m = _turn_masks(3)
    y_masks = None
    if masked:
        stop = np.concatenate([m, np.zeros((1, B, 1), np.float32)])
        y_masks = np.minimum(1.0 - stop[1:], stop[:-1])
    got = tl.get_rec_outp(torch.from_numpy(y),
                          None if y_masks is None else torch.from_numpy(y_masks))
    want = jl.get_rec_outp(jnp.asarray(y),
                           None if y_masks is None else jnp.asarray(y_masks))
    for g, w in zip(got, want):
        _close(g, w)


# Unmasked, and masks selecting 0, 1, 2 and all rows; batch 1 skips the
# std normalization (the reference's ``batch > 1`` guard).
BINARY_CASES = {
    "unmasked": dict(rows=None),
    "mask_0_rows": dict(rows=0),
    "mask_1_row": dict(rows=1),
    "mask_2_rows": dict(rows=2),
    "mask_all_rows": dict(rows=B),
    "unmasked_batch_1": dict(rows=None, batch=1),
    "masked_batch_1": dict(rows=1, batch=1),
    "no_entropy": dict(rows=3, penalty=None),
}


@pytest.mark.parametrize("name", list(BINARY_CASES))
def test_calculate_loss_binary_matches_jax(name):
    case = {"batch": B, "penalty": 0.01, **BINARY_CASES[name]}
    feats, probs, logs, scores = _inputs(4, case["batch"])
    mask = (None if case["rows"] is None
            else _row_mask(case["batch"], case["rows"], 5))

    def jax_fn(p):
        return jl.calculate_loss_binary(
            jnp.asarray(feats), p, jnp.asarray(logs), jnp.asarray(scores),
            case["penalty"], None if mask is None else jnp.asarray(mask))

    (want_loss, want_ent), grad = jax.value_and_grad(
        jax_fn, has_aux=True)(jnp.asarray(probs))
    p = torch.from_numpy(probs).requires_grad_()
    loss, ent = tl.calculate_loss_binary(
        torch.from_numpy(feats), p, torch.from_numpy(logs),
        torch.from_numpy(scores), case["penalty"],
        None if mask is None else torch.from_numpy(mask))
    loss.backward()
    _close(loss, want_loss)
    _close(ent, want_ent)
    _close(p.grad, grad)
    if case["rows"] == 0:
        assert loss.item() == 0.0 and ent.item() == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_multistep_loss_binary_matches_jax(masked):
    feats, probs, logs, scores = _inputs(6, turns=T)
    masks = _turn_masks(7) if masked else None

    def jax_fn(p):
        return jl.multistep_loss_binary(
            jnp.asarray(feats), p, jnp.asarray(logs), jnp.asarray(scores),
            None if masks is None else jnp.asarray(masks), 0.08)

    (want_loss, want_ent), grad = jax.value_and_grad(
        jax_fn, has_aux=True)(jnp.asarray(probs))
    p = torch.from_numpy(probs).requires_grad_()
    loss, ent = tl.multistep_loss_binary(
        torch.from_numpy(feats), p, torch.from_numpy(logs),
        torch.from_numpy(scores),
        None if masks is None else torch.from_numpy(masks), 0.08)
    loss.backward()
    _close(loss, want_loss)
    _close(ent, want_ent)
    _close(p.grad, grad)


# The batched form: every turn of a ``(T', B, ...)`` stack in one call,
# held against the JAX package's ``vmap`` over the turns. Masks are
# cumulative over turns as the conversation makes them; ``zero`` turns
# select no row and ``one`` turns exactly one (std 0, clamped to 1).
TURN_CASES = {
    "turns_1": dict(turns=1),
    "turns_9": dict(turns=9),
    "turns_10": dict(turns=10),
    "turns_10_unmasked": dict(turns=10, masked=False),
    "turns_1_unmasked": dict(turns=1, masked=False),
    "zero_mask_turn": dict(turns=10, zero=(4,)),
    "one_row_turn": dict(turns=10, one=(3,)),
    "zero_and_one_row_turns": dict(turns=9, zero=(7, 8), one=(2, 5)),
    "batch_1": dict(turns=10, batch=1),
    "batch_1_unmasked": dict(turns=9, batch=1, masked=False),
    "no_entropy": dict(turns=10, penalty=None, one=(6,)),
    "no_entropy_unmasked": dict(turns=9, penalty=None, masked=False),
}


def _turn_case(name, seed):
    """A case's inputs: bits, probabilities, rewards, scores and masks
    (``None`` unmasked), and the entropy penalty."""
    case = {"batch": B, "penalty": 0.08, "masked": True, "zero": (),
            "one": (), **TURN_CASES[name]}
    turns, batch = case["turns"], case["batch"]
    feats, probs, logs, scores = _inputs(seed, batch, turns)
    masks = None
    if case["masked"]:
        masks = _turn_masks(seed + 1, turns, batch)
        rng = np.random.RandomState(seed + 2)
        for t in case["zero"]:
            masks[t] = 0.0
        for t in case["one"]:
            masks[t] = 0.0
            masks[t, rng.randint(batch)] = 1.0
        for t in case["zero"] + case["one"]:
            assert masks[t].sum() == (t in case["one"])
    return feats, probs, logs, scores, masks, case["penalty"]


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("name", list(TURN_CASES))
def test_calculate_loss_binary_over_turns_matches_jax_vmap(name):
    """One call on the stack: each turn's loss and negentropy, and the
    gradient of their sum, as JAX's ``vmap`` of the one-turn function."""
    feats, probs, logs, scores, masks, penalty = _turn_case(name, 20)

    def jax_fn(p):
        def one(f, pt, s, m):
            return jl.calculate_loss_binary(f, pt, jnp.asarray(logs), s,
                                            penalty, m)
        losses, ents = jax.vmap(one, in_axes=(0, 0, 0, 0 if masks is
                                              not None else None))(
            jnp.asarray(feats), p, jnp.asarray(scores), _jnp(masks))
        return losses.sum() + 0.5 * ents.sum(), (losses, ents)

    (_, (want_losses, want_ents)), grad = jax.value_and_grad(
        jax_fn, has_aux=True)(jnp.asarray(probs))
    p = torch.from_numpy(probs).requires_grad_()
    losses, ents = tl.calculate_loss_binary(
        torch.from_numpy(feats), p, torch.from_numpy(logs),
        torch.from_numpy(scores), penalty, _torch(masks))
    (losses.sum() + 0.5 * ents.sum()).backward()
    assert losses.shape == ents.shape == (feats.shape[0],)
    _close(losses, want_losses)
    _close(ents, want_ents)
    _close(p.grad, grad)
    if masks is not None:
        empty = masks.sum(axis=(1, 2)) == 0
        assert (losses.detach().numpy()[empty] == 0.0).all()
        assert (ents.detach().numpy()[empty] == 0.0).all()


@pytest.mark.parametrize("name", list(TURN_CASES))
def test_multistep_loss_binary_cases_match_jax(name):
    feats, probs, logs, scores, masks, penalty = _turn_case(name, 30)

    def jax_fn(p):
        return jl.multistep_loss_binary(
            jnp.asarray(feats), p, jnp.asarray(logs), jnp.asarray(scores),
            _jnp(masks), penalty)

    (want_loss, want_ent), grad = jax.value_and_grad(
        jax_fn, has_aux=True)(jnp.asarray(probs))
    p = torch.from_numpy(probs).requires_grad_()
    loss, ent = tl.multistep_loss_binary(
        torch.from_numpy(feats), p, torch.from_numpy(logs),
        torch.from_numpy(scores), _torch(masks), penalty)
    loss.backward()
    _close(loss, want_loss)
    _close(ent, want_ent)
    _close(p.grad, grad)


@pytest.mark.parametrize("name", list(TURN_CASES))
def test_calculate_loss_bas_over_turns_matches_jax_vmap(name):
    _, _, logs, scores, masks, _ = _turn_case(name, 40)

    def jax_fn(s):
        def one(st, m):
            return jl.calculate_loss_bas(st, jnp.asarray(logs), m)
        losses = jax.vmap(one, in_axes=(0, 0 if masks is not None
                                        else None))(s, _jnp(masks))
        return (losses * jnp.arange(1, len(losses) + 1)).sum(), losses

    (_, want), grad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    got = tl.calculate_loss_bas(s, torch.from_numpy(logs), _torch(masks))
    (got * torch.arange(1, len(got) + 1)).sum().backward()
    assert got.shape == (scores.shape[0],)
    _close(got, want)
    _close(s.grad, grad)


@pytest.mark.parametrize("name", list(TURN_CASES))
def test_multistep_loss_bas_cases_match_jax(name):
    _, _, logs, scores, masks, _ = _turn_case(name, 50)
    fn = lambda s: jl.multistep_loss_bas(  # noqa: E731
        s, jnp.asarray(logs), _jnp(masks))
    want, grad = jax.value_and_grad(fn)(jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    got = tl.multistep_loss_bas(s, torch.from_numpy(logs), _torch(masks))
    got.backward()
    _close(got, want)
    _close(s.grad, grad)


@pytest.mark.parametrize("rows", [None, 0, 1, 2])
def test_calculate_loss_bas_matches_jax(rows):
    _, _, logs, scores = _inputs(8)
    mask = None if rows is None else _row_mask(B, rows, 9)
    fn = lambda s: jl.calculate_loss_bas(  # noqa: E731
        s, jnp.asarray(logs), None if mask is None else jnp.asarray(mask))
    want, grad = jax.value_and_grad(fn)(jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    got = tl.calculate_loss_bas(s, torch.from_numpy(logs),
                                None if mask is None
                                else torch.from_numpy(mask))
    got.backward()
    _close(got, want)
    _close(s.grad, grad)
    if rows == 0:
        assert got.item() == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_multistep_loss_bas_matches_jax(masked):
    _, _, logs, scores = _inputs(10, turns=T)
    masks = _turn_masks(11) if masked else None
    fn = lambda s: jl.multistep_loss_bas(  # noqa: E731
        s, jnp.asarray(logs), None if masks is None else jnp.asarray(masks))
    want, grad = jax.value_and_grad(fn)(jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    got = tl.multistep_loss_bas(s, torch.from_numpy(logs),
                                None if masks is None
                                else torch.from_numpy(masks))
    got.backward()
    _close(got, want)
    _close(s.grad, grad)


def _record(turns, batch=64, width=32, classes=30, seed=0):
    """A differentiable conversation record of the ``adaptive`` widths:
    cumulative stop masks, sampled bits, and leaf probabilities, class
    scores and baseline scores."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)

    def leaf(x):
        return x.requires_grad_()

    alive = (u(turns, batch, 1) < 0.8).float().cummin(0).values
    stop = torch.cat([torch.ones(1, batch, 1), alive[:-1],
                      torch.zeros(1, batch, 1)])
    return ExchangeOutputs(
        stop_masks=stop, stop_feats=(u(turns, batch, 1) < 0.5).float(),
        stop_probs=leaf(u(turns, batch, 1) * 0.9 + 0.05),
        sen_feats=(u(turns, batch, width) < 0.5).float(),
        sen_probs=leaf(u(turns, batch, width) * 0.9 + 0.05),
        rec_feats=(u(turns, batch, width) < 0.5).float(),
        rec_probs=leaf(u(turns, batch, width) * 0.9 + 0.05),
        y=leaf(torch.randn(turns, batch, classes, generator=g)),
        bs=leaf(torch.randn(turns, batch, 1, generator=g)),
        br=leaf(torch.randn(turns, batch, 1, generator=g)),
        n_steps=torch.tensor(turns), attn_scores=None)


def _leaf_ops(fn):
    """The operators ``fn()`` runs that call no other, under the
    profiler on the CPU."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if not e.cpu_children)


@pytest.mark.parametrize("phase", ["forward", "backward"])
def test_loss_layer_operators_do_not_grow_with_turns(phase):
    """Every multi-turn loss is one pass over the stacked turns, so the
    loss layer runs as many operators at ``max_exchange`` 2 as at 10, in
    its forward and in its backward."""
    counts = []
    for turns in (2, 10):
        cfg = GameConfig(max_exchange=turns, fixed_exchange=False,
                         sender_out_dim=32, rec_w_dim=32, entropy_s=0.08,
                         entropy_sen=0.01, entropy_rec=0.01)
        ex = _record(turns)
        target = torch.arange(64) % 30
        out = {}

        def forward():
            out["total"] = losses_from_exchange(cfg, ex, target, 6, 64)[0]
        forward_ops = _leaf_ops(forward)
        backward_ops = _leaf_ops(lambda: out["total"].backward())
        counts.append(forward_ops if phase == "forward" else backward_ops)
        assert all(t.grad is not None for t in (ex.stop_probs, ex.sen_probs,
                                                ex.rec_probs, ex.y, ex.bs,
                                                ex.br))
    assert counts[0] == counts[1], counts


@pytest.mark.parametrize("k", [1, 2, 3, 20])
def test_topk_accuracy_matches_jax_with_ties(k):
    """Tied scores: the target's rank counts only strictly higher
    classes, so a target tied with the k-th score is a hit; torch.topk
    would cut ties by position. k above the class count clamps."""
    rng = np.random.RandomState(12)
    dist = rng.randn(B, D).astype(np.float32)
    target = rng.randint(0, D, B)
    for b in range(B):                      # tie the target with others
        dist[b, (target[b] + 1) % D] = dist[b, target[b]]
        dist[b, (target[b] + 2) % D] = dist[b, target[b]]
    dist[0, :] = 1.0                        # all classes tied
    got = tl.topk_accuracy(torch.from_numpy(dist), torch.from_numpy(target),
                           k, 16)
    want = jl.topk_accuracy(jnp.asarray(dist), jnp.asarray(target), k, 16)
    _close(got, want)
    assert float(got) >= 1 / 16             # row 0 is a hit at every k


def _baseline_setup():
    kw = dict(img_feat_dim=20, img_h_dim=12, sender_out_dim=10,
              rec_w_dim=10, rec_hidden=14, wv_dim=16, baseline_hid_dim=9)
    jm = JaxModules(JaxConfig(**kw))
    jp = jax_init_params(jm, jax.random.PRNGKey(0), num_classes=D)
    mods = load_torch_state(AgentModules(GameConfig(**kw)),
                            params_to_torch_state(jp))
    return jm, jp, mods


def test_baselines_forward_matches_jax():
    jm, jp, mods = _baseline_setup()
    rng = np.random.RandomState(13)
    h_x = rng.randn(B, 12).astype(np.float32)
    w = (rng.rand(B, 10) < 0.5).astype(np.float32)
    h_z = rng.randn(B, 14).astype(np.float32)
    want_s = jm.baseline_sen.apply({"params": jp["baseline_sen"]},
                                   jnp.asarray(h_x), jnp.asarray(w), None)
    want_r = jm.baseline_rec.apply({"params": jp["baseline_rec"]},
                                   None, jnp.asarray(w), jnp.asarray(h_z))
    got_s = mods.baseline_sen(torch.from_numpy(h_x), torch.from_numpy(w),
                              None)
    got_r = mods.baseline_rec(None, torch.from_numpy(w),
                              torch.from_numpy(h_z))
    _close(got_s, want_s)
    _close(got_r, want_r)
    # Stacked over turns: the same scores turn by turn.
    stacked = mods.baseline_rec(None, torch.from_numpy(np.stack([w, w])),
                                torch.from_numpy(np.stack([h_z, h_z])))
    _close(stacked[1], want_r)


def test_baseline_init_is_torch_default_in_distribution():
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases, as an
    ``nn.Linear`` draws them and as the JAX init draws them; the same
    seed gives the same weights."""
    base = Baseline(500, 256, 32, 0)
    base.reset_parameters(torch.Generator().manual_seed(1))
    torch.manual_seed(0)
    for layer in (base.linear1, base.linear2):
        bound = 1.0 / np.sqrt(layer.in_features)
        ref = torch.nn.Linear(layer.in_features, layer.out_features)
        for got, want in ((layer.weight, ref.weight), (layer.bias, ref.bias)):
            assert float(got.abs().max()) <= bound
            if got.numel() >= 100:
                assert abs(float(got.std()) / float(want.std()) - 1) < 0.1
                assert abs(float(got.mean())) < 0.1 * bound
    kw = dict(img_feat_dim=512, img_h_dim=256, sender_out_dim=32,
              rec_w_dim=32, rec_hidden=64, baseline_hid_dim=500)
    jp = params_to_torch_state(jax_init_params(JaxModules(JaxConfig(**kw)),
                                               jax.random.PRNGKey(3)))
    mods = init_params(AgentModules(GameConfig(**kw)), seed=3)
    again = init_params(AgentModules(GameConfig(**kw)), seed=3)
    for agent in ("baseline_sen", "baseline_rec"):
        got = getattr(mods, agent).state_dict()
        assert set(got) == set(jp[agent])
        for name, v in got.items():
            layer = getattr(getattr(mods, agent), name.split(".")[0])
            bound = 1.0 / np.sqrt(layer.in_features)
            assert float(v.abs().max()) <= bound, (agent, name)
            if v.numel() >= 100:
                ratio = float(v.std()) / float(np.std(jp[agent][name]))
                assert abs(ratio - 1) < 0.1, (agent, name, ratio)
            assert torch.equal(v, getattr(again, agent).state_dict()[name])

"""Tensor parallelism of the port (``parallel/tensor.py``) on gloo CPU
ranks against JAX's ``make_sharded_train_step`` on ``make_mesh_2d``
(tests/conftest.py forces 8 virtual CPU devices), in float64, as
tests/test_torch_mesh_step.py holds data parallelism.

Both start from the same weights (``params_to_torch_state``); JAX's
weights are placed by ``shard_params_tp`` with ``init_tp_opt_states``,
the port's cut by ``TensorParallel`` with ``init_tp_opt_states``, and
each rank replays JAX's uniforms for the whole batch. After two steps the
losses, the accuracy and every weight's change (the port's whole weights,
gathered over the model axis) must agree at ~1e-9. The cases: meshes
(1, 2) and (2, 2), RMSprop and Adam, the description rows replicated and
class-sharded (``class_axis_placer``), the ``mou`` mix (whose row-parallel
``binary_layer`` is blocked apart from the hidden width), a ragged hidden
width (the sender's leaves replicated, the baselines' sharded) and a
ragged class count (the head replicated). Also: the placement specs leaf
by leaf against JAX's ``tp_param_specs``, the optimizer-placement check,
and the step's collectives per axis against the count PERF.md predicts
(the counterpart of tests/test_hlo_collectives.py:127-231). The (1, 2)
cases are here, the (2, 2) ones in tests/test_torch_tensor_parallel_grid.py
(the cases themselves: tests/tp_cases.py).
"""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.parallel.tensor import (
    MODEL_AXIS, tp_param_specs as jax_tp_param_specs)
from multimodalgame_tpu_torch.game.agents import AgentModules, init_params
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.train import init_opt_states
from multimodalgame_tpu_torch.parallel.mesh import Mesh
from multimodalgame_tpu_torch.parallel.tensor import (
    TensorParallel, _check_opt_placement, class_axis_placer,
    count_model_sharded, place_opt_states_tp, tp_param_specs)
from tests.tp_cases import (BASE, CASES, check_collectives,
                            check_steps_match_jax, port_results_for)

SHAPE = (1, 2)
NAMES = [n for n, c in CASES.items() if c[0] == SHAPE]


@pytest.fixture(scope="module")
def port_results():
    return port_results_for(SHAPE)


@pytest.mark.parametrize("name", NAMES)
def test_tp_steps_match_jax(name, port_results):
    check_steps_match_jax(name, port_results[name])


@pytest.mark.parametrize("name", NAMES)
def test_collectives_per_axis(name, port_results):
    check_collectives(name, port_results[name])


def test_slots_are_shaped_like_their_shards(port_results):
    got = port_results["rmsprop_1x2"][0]["slot_shapes"]
    assert got["image_layer.weight"] == (8, 32)       # column-parallel
    assert got["image_layer.bias"] == (8,)
    assert got["binary_layer.weight"] == (8, 8)       # row-parallel
    assert got["binary_layer.bias"] == (8,)           # replicated
    assert port_results["ragged_hidden_1x2"][0]["slot_shapes"][
        "image_layer.weight"] == (15, 32)


def _jax_specs_as_port(params, n_model):
    """JAX's spec tree as ``{torch name: torch dim or None}`` for the
    leaves with a torch twin of the same name (a flax kernel is the
    transpose of a torch weight)."""
    specs = jax_tp_param_specs(params, n_model)
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, P)):
        keys = [p.key for p in path]
        if keys[-1] not in ("kernel", "bias") or len(keys) != 3:
            continue
        name = ".".join(keys[:2] + ["weight" if keys[-1] == "kernel"
                                    else "bias"])
        dims = [i for i, a in enumerate(spec) if a == MODEL_AXIS]
        if not dims:
            out[name] = None
        elif keys[-1] == "kernel":
            out[name] = 1 - dims[0]
        else:
            out[name] = dims[0]
    return out, specs


@pytest.mark.parametrize("over", [{}, {"sender_mix": "mou"},
                                  {"visual_attn": True,
                                   "attn_extra_context": True},
                                  {"img_h_dim": 15, "baseline_hid_dim": 12}],
                         ids=["adaptive", "mou", "attention", "ragged"])
@pytest.mark.parametrize("n_model", [2, 3, 4, 8])
def test_specs_equal_jax_leaf_by_leaf(over, n_model):
    kw = {**BASE, **over}
    params = jax_init_params(JaxModules(JaxConfig(**kw)),
                             jax.random.PRNGKey(0), num_classes=8)
    want, tree = _jax_specs_as_port(params, n_model)
    got = tp_param_specs(AgentModules(GameConfig(**kw)), n_model)
    for name, dim in want.items():
        assert got[name] == dim, name
    # Every other leaf (the receiver's, the code biases) is replicated.
    assert all(got[n] is None for n in set(got) - set(want))
    jax_count = sum(any(a == MODEL_AXIS for a in s if a is not None)
                    for s in jax.tree_util.tree_leaves(
                        tree, is_leaf=lambda x: isinstance(x, P)))
    assert count_model_sharded(got) == jax_count


def _grid(m=1, n_model=2):
    """A rank's axes with no process group (nothing here collects)."""
    mesh = Mesh(0, 1, "cpu", "gloo", global_rank=m)
    mesh.model = Mesh(m, n_model, "cpu", "gloo", global_rank=m)
    return mesh


def test_opt_placement_check_catches_slots_that_do_not_mirror():
    cfg = GameConfig(**{**BASE, "optim_type": "Adam"})
    full = init_params(AgentModules(cfg), seed=0, device="cpu")
    tp = TensorParallel(_grid(), full)
    # The whole model's slots are not this rank's shards.
    whole = init_opt_states(cfg, full)
    with pytest.raises(ValueError, match="does not mirror"):
        _check_opt_placement(whole, tp.shard, tp.specs)
    placed = place_opt_states_tp(whole, tp)
    assert _check_opt_placement(placed, tp.shard, tp.specs) == \
        2 * count_model_sharded(tp.specs)
    # A slot list that is short of the parameters raises too.
    placed["sender"]["nu"] = placed["sender"]["nu"][:-1]
    with pytest.raises(ValueError, match="accumulators for"):
        _check_opt_placement(placed, tp.shard, tp.specs)


def test_shards_take_the_ranks_block_and_share_the_rest():
    cfg = GameConfig(**BASE)
    full = init_params(AgentModules(cfg), seed=0, device="cpu")
    tp = TensorParallel(_grid(m=1), full, num_classes=8)
    w = full.sender.image_layer.weight
    assert torch.equal(tp.shard.sender.image_layer.weight, w[8:])
    b = full.sender.binary_layer.weight
    assert torch.equal(tp.shard.sender.binary_layer.weight, b[:, 8:])
    assert tp.shard.receiver.rnn.weight_hh is full.receiver.rnn.weight_hh
    assert tp.shard.sender.binary_layer.bias is full.sender.binary_layer.bias
    # The parameters keep their order (optimizer slots by position).
    assert [n for n, _ in tp.shard.named_parameters()] == \
        [n for n, _ in full.named_parameters()]
    assert tp.seams["receiver"].classes and tp.seams["sender"].row
    ragged = TensorParallel(_grid(m=1), full, num_classes=5)
    assert not ragged.seams["receiver"].classes and not ragged.partial


def test_class_axis_placer_blocks_and_falls_back():
    place = class_axis_placer(_grid(m=1, n_model=2).model)
    x = torch.arange(8 * 3.0).reshape(8, 3)
    assert torch.equal(place(x), x[4:])
    assert place(torch.ones(5, 2)).shape == (5, 2)      # ragged: whole
    assert place(torch.ones(8, 4, 3)).shape == (4, 4, 3)
    assert place(None) is None

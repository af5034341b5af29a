"""The captured train step's returned state aliases its own buffers.

``make_train_step`` returns a ``TrainProgram`` that updates the state in
place: the state call k returns is the step's static buffers, and call
k + 1 overwrites it (a standing divergence from JAX's jitted step,
which donates nothing). With ``graphs=False`` the functional step
returns fresh tensors, and a returned state keeps its values, as JAX's.
Reduced llama3.2-1b on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training.train_loop import (TrainProgram,  # noqa: E402
                                             init_train_state,
                                             make_train_step)


def _steps(graphs):
    model = build(get_arch("llama3.2-1b", variant="reduced"), device="cpu")
    opt = opt_mod.AdamW(lr=opt_mod.cosine_schedule(1e-3, 2, 10))
    step = make_train_step(model, opt, graphs=graphs)
    it = pipeline.batches_for(model.cfg, 2, 16, seed=1)
    state = init_train_state(model, opt, seed=0)
    s1, _ = step(state, next(it))
    snap = [t.clone() for t in tree_leaves(s1)]
    s2, _ = step(s1, next(it))
    return step, s1, snap, s2


@pytest.mark.parametrize("graphs", [None, False], ids=["program", "eager"])
def test_returned_state_after_the_next_step(graphs):
    step, s1, snap, s2 = _steps(graphs)
    leaves1, leaves2 = tree_leaves(s1), tree_leaves(s2)
    if graphs is None:
        assert isinstance(step, TrainProgram)
        # call 1's state is call 2's buffers: it reads call 2's values
        assert all(a is b for a, b in zip(leaves1, leaves2))
        assert int(s1["step"]) == 2
        assert not all(torch.equal(a, b) for a, b in zip(leaves1, snap))
    else:
        # the functional step: call 1's state keeps its values
        assert not any(a is b for a, b in zip(leaves1, leaves2))
        assert int(s1["step"]) == 1 and int(s2["step"]) == 2
        assert all(torch.equal(a, b) for a, b in zip(leaves1, snap))

"""The PyTorch port's training launcher, step configuration and state
files against the JAX package's, on the CPU.

* ``launch/steps.py``: ``resolve_config`` over every architecture and
  every shape of ``SHAPES`` equal to JAX's on the fields the port's
  config carries, and ``ShapeSkip`` exactly where JAX raises it;
  ``depth_counts``, ``with_depth`` and ``apply_opts``.
* ``Model.cache_len`` and ``Model.input_specs``: the stand-ins' tree,
  shapes and dtypes equal to the JAX package's ``ShapeDtypeStruct``s
  (``jax.eval_shape`` of the cache) for every architecture and shape,
  on the ``meta`` device.
* Train states (``save_train_state`` / ``load_train_state``): a round
  trip on reduced mamba2-780m; a JAX-written state (bf16 leaves
  included) read by the port; a port-written fp32 state read by JAX
  (JAX's loader refuses the port's bf16 leaves, ROADMAP section 3).
* ``save_quantized`` / ``load_quantized`` in both directions, int8 and
  int4 trees, with JAX's ``{"format": "qtensor"}`` tag.
* ``python -m repro_torch.launch.train --device cpu``: its console
  lines and the JSONL records' keys equal to JAX's CLI's, its ``--save``
  read back by ``load_train_state``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch import train as jax_train_cli  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.quant import params as jax_qparams  # noqa: E402
from repro.training import checkpoints as jax_ckpt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_arch  # noqa: E402
from repro_torch.core.pytree import (tree_flatten_with_path,  # noqa: E402
                                     tree_leaves)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.quant import params as qparams  # noqa: E402
from repro_torch.training import checkpoints as ckpt  # noqa: E402
from repro_torch.training.optimizer import AdamW, constant_schedule  # noqa: E402
from repro_torch.training.train_loop import init_train_state  # noqa: E402

CASES = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]


def _same_fields(jc, tc):
    """Every field of the port's config equal to JAX's (nested configs
    field by field)."""
    for f in dataclasses.fields(tc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if dataclasses.is_dataclass(b):
            _same_fields(a, b)
        else:
            assert a == b, (tc.name, f.name, a, b)


@pytest.mark.parametrize("arch,shape", CASES)
def test_resolve_config_matches_jax(arch, shape):
    try:
        want = jax_steps.resolve_config(arch, shape)
    except jax_steps.ShapeSkip:
        with pytest.raises(steps.ShapeSkip):
            steps.resolve_config(arch, shape)
        return
    got = steps.resolve_config(arch, shape)
    _same_fields(want, got)
    assert got.remat == (SHAPES[shape].mode == "train")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_depth_counts_with_depth_and_opts_match_jax(arch):
    jc, tc = jax_get_arch(arch), get_arch(arch)
    counts = steps.depth_counts(tc)
    assert counts == jax_steps.depth_counts(jc)
    small = {k: 1 for k in counts}
    _same_fields(jax_steps.with_depth(jc, small), steps.with_depth(tc, small))
    assert steps.depth_counts(steps.with_depth(tc, small)) == small
    assert steps.with_depth(tc, counts) == tc
    opts = {"moe_group": True, "ssd_chunk": 64, "attn_block": 128,
            "kv_quant": True}
    _same_fields(jax_steps.apply_opts(jc, opts), steps.apply_opts(tc, opts))
    assert steps.apply_opts(tc, {}) == tc


def _spec_dict(tree, is_torch):
    if is_torch:
        return {"/".join(str(k) for k in p): (tuple(x.shape),
                                               str(x.dtype)[6:])
                for p, x in tree_flatten_with_path(tree)}
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_len_and_input_specs_match_jax(arch):
    jm, tm = jax_build(jax_get_arch(arch)), build(get_arch(arch),
                                                   device="cpu")
    for shape in sorted(SHAPES):
        js, ts = JAX_SHAPES[shape], SHAPES[shape]
        assert tm.cache_len(ts) == jm.cache_len(js)
        got = tm.input_specs(ts)
        assert all(x.device.type == "meta" for x in tree_leaves(got))
        assert _spec_dict(got, True) == _spec_dict(jm.input_specs(js),
                                                    False), (arch, shape)


# --------------------------------------------------------------------- #
# train states and quantized trees
# --------------------------------------------------------------------- #
def test_train_state_roundtrip_mamba2(tmp_path):
    model = build(get_arch("mamba2-780m", variant="reduced"), device="cpu")
    opt = AdamW(lr=constant_schedule(1e-3))
    state = init_train_state(model, opt, seed=0)
    ckpt.save_train_state(tmp_path, 7, state["params"], state["opt"])
    step, params, opt_state = ckpt.load_train_state(tmp_path, device="cpu")
    assert step == 7
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(state["opt"]), tree_leaves(opt_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert opt_state["step"].dtype == torch.int32


def test_port_reads_a_jax_written_bf16_train_state(tmp_path):
    from repro.training.optimizer import AdamW as JAdamW
    from repro.training.optimizer import constant_schedule as jconst
    jc = jax_get_arch("llama3.2-1b", variant="reduced").replace(
        dtype="bfloat16", param_dtype="bfloat16")
    jm = jax_build(jc)
    jp = jm.init(jax.random.PRNGKey(1))
    jo = JAdamW(lr=jconst(1e-3)).init(jp)
    jax_ckpt.save_train_state(tmp_path, 3, jp, jo)
    step, params, opt_state = ckpt.load_train_state(tmp_path, device="cpu")
    assert step == 3
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                  get_arch("llama3.2-1b", variant="reduced")
                                  .replace(dtype="bfloat16",
                                           param_dtype="bfloat16"), "cpu")
    for a, b in zip(tree_leaves(want), tree_leaves(params)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)
    assert opt_state["step"].dtype == torch.int32
    assert int(opt_state["step"]) == 0
    for leaf in tree_leaves(opt_state["m"]):
        assert leaf.dtype == torch.float32 and not leaf.any()


def test_jax_reads_a_port_written_fp32_train_state(tmp_path):
    model = build(get_arch("llama3.2-1b", variant="reduced"), device="cpu")
    opt = AdamW(lr=constant_schedule(1e-3))
    state = init_train_state(model, opt, seed=2)
    ckpt.save_train_state(tmp_path, 5, state["params"], state["opt"])
    step, params, opt_state = jax_ckpt.load_train_state(tmp_path)
    assert step == 5
    got = jax.tree_util.tree_flatten_with_path(params)[0]
    for (_, a), b in zip(got, tree_leaves(state["params"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.asarray(opt_state["step"]).dtype == np.int32


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_trees_cross_both_ways(tmp_path, bits):
    cfg = get_arch("llama3.2-1b", variant="reduced")
    model = build(cfg, device="cpu")
    q = qparams.quantize_params(model.init(0), bits=bits)
    digest = qparams.save_quantized(tmp_path / "port", q)
    man = json.loads((tmp_path / "port.json").read_text())
    assert man["format"] == "qtensor" and man["hash"] == digest
    back = qparams.load_quantized(tmp_path / "port", device="cpu")
    jback = jax_qparams.load_quantized(tmp_path / "port")
    for a, b in zip(tree_leaves(q), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for (_, a), b in zip(jax.tree_util.tree_flatten_with_path(jback)[0],
                         tree_leaves(q)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the other way: JAX quantizes and saves, the port reads
    jm = jax_build(jax_get_arch("llama3.2-1b", variant="reduced"))
    jq = jax_qparams.quantize_params(jm.init(jax.random.PRNGKey(0)),
                                     bits=bits)
    jax_qparams.save_quantized(tmp_path / "jax", jq)
    assert json.loads((tmp_path / "jax.json").read_text())["format"] \
        == "qtensor"
    got = qparams.load_quantized(tmp_path / "jax", device="cpu")
    for (_, a), b in zip(jax.tree_util.tree_flatten_with_path(jq)[0],
                         tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
def test_train_cli_matches_jax_lines_and_records(tmp_path, capsys):
    args = ["--arch", "llama3.2-1b", "--variant", "reduced", "--steps", "3",
            "--batch", "4", "--seq", "32", "--log-every", "1"]
    hist = train_cli.main(args + ["--device", "cpu", "--save",
                                  str(tmp_path / "port"), "--metrics",
                                  str(tmp_path / "port.jsonl")])
    port_out = capsys.readouterr().out.splitlines()
    jhist = jax_train_cli.main(args + ["--save", str(tmp_path / "jax"),
                                       "--metrics",
                                       str(tmp_path / "jax.jsonl")])
    jax_out = capsys.readouterr().out.splitlines()
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert set(hist[0]) == set(jhist[0])
    assert len(port_out) == len(jax_out)
    assert port_out[-1] == f"saved to {tmp_path / 'port'}"
    assert jax_out[-1] == f"saved to {tmp_path / 'jax'}"
    for a, b in zip(port_out[:-1], jax_out[:-1]):
        assert [w.split("=")[0] for w in a.split()] == \
            [w.split("=")[0] for w in b.split()]
    recs = [json.loads(ln) for ln in
            (tmp_path / "port.jsonl").read_text().splitlines()]
    jrecs = [json.loads(ln) for ln in
             (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert [set(r) for r in recs] == [set(r) for r in jrecs]
    step, params, opt_state = ckpt.load_train_state(tmp_path / "port",
                                                    device="cpu")
    assert step == 3 and int(opt_state["step"]) == 3
    assert json.loads((tmp_path / "port" / "history.json").read_text()) \
        == hist


def test_train_cli_without_a_card_exits():
    """The default device is CUDA: without a card the CLI exits with an
    error instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(SystemExit, match="CUDA"):
        train_cli.main(["--steps", "1"])

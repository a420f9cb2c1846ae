"""The port's parallel modes on gloo ranks on the CPU
(``frankenstein_tpu_torch/parallel``, ``train/trainer.py:setup_parallel``,
``eval/submission.make_predictions``): each suite of
``tests/torch_parallel_workers.py`` runs once on its ranks (separate
processes, each with its own time limit) and every check it reports is a
case here, held to the JAX tests' tolerances (``tests/test_fsdp.py``,
``test_moe.py``, ``test_ring_attention.py``, ``test_parallel_pipeline.py``,
``test_sharded_decode.py``). Ring attention is also held to the JAX
package's ``ring_attention_sharded`` on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from frankenstein_tpu.parallel import ring_attention as jra
from frankenstein_tpu_torch.parallel import sharding as shard_lib
from tests.torch_parallel_workers import spawn

TRAIN = {"loss": 1e-5, "params": 5e-5, "resume": 0.0}
TRAIN_CHECKS = [f"{run}/{key}" for run in ("dp", "fsdp", "moe_dp",
                                           "moe_dp_ep", "mae")
                for key in TRAIN]
# the VQ-VAE over data groups of 4 and 2 ranks and with 2 microbatches:
# relative errors (f32, only reassociation apart) and flags
VQ_TOL = {"loss": 1e-5, "perplexity": 1e-5, "commit_loss": 1e-5,
          "params": 1e-5, "buffers": 1e-5, "same_on_ranks": None,
          "refreshed": None}
VQ_CHECKS = [f"{run}/{key}" for run in ("vq_dp4", "vq_dp2", "vq_dp4_accum2")
             for key in VQ_TOL]
EXPERT_TOL = {"ep/y": 1e-5, "ep/aux": 1e-6, "ep/grads": 1e-5,
              "ep/gpt_loss": 1e-6, "ep/shard_shape": None}
LAYOUT_TOL = {
    "tp/llama_loss": 1e-5, "tp/llama_grads": 1e-5, "tp/llama_sharded": None,
    "tp/franky_llama_loss": 1e-5, "tp/franky_llama_grads": 1e-5,
    "pp/out": 1e-6, "pp/grads": 1e-5, "dp_pp/out": 1e-6,
    "dp_pp/grads": 1e-5, "pp/refused": None,
    **{f"ring/{m}/{k}": t for m in ("full", "causal", "slab")
       for k, t in (("dense", 2e-5), ("jax", 2e-5), ("grads", 1e-4))},
    "ring/refused": None,
    "seq_parallel/out": 2e-5, "seq_parallel/grads": 3e-5,
    "serve/greedy": None, "serve/beam": None, "serve/int8_kv": None,
    "serve/strings": None,
    **{f"{run}/{k}": t for run in (
        "gpt_tp/tp2", "gpt_tp/tp2_dp2", "gpt_tp/tp2_dropout",
        "gpt_tp/tp2_dp2_dropout", "gpt_tp/franky_tp2",
        "gpt_tp/franky_tp2_dp2_dropout", "gpt_tp/indivisible",
        "llama_tp/indivisible")
       for k, t in (("loss", 1e-5), ("logits", 1e-5), ("grads", 1e-5),
                    ("step", 5e-5), ("split", None))},
    "gpt_tp/serving_refused": None, "llama_tp/serving_refused": None,
}
SLAB = 4


def _ring_refs():
    """q, k, v [2, 32, 2, 8], the loss weights, the JAX package's ring
    outputs over a 4-device "seq" mesh, and an encoder input."""
    rng = np.random.default_rng(0)
    q, k, v, w = (rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
                  for _ in range(4))
    mesh = Mesh(np.asarray(jax.devices()[:4]), (jra.SEQ_AXIS,))
    refs = {"ring_q": q, "ring_k": k, "ring_v": v, "ring_w": w,
            "enc_x": rng.standard_normal((2, 32, 8)).astype(np.float32)}
    for mode, kw in (("full", {}), ("causal", {"causal": True}),
                     ("slab", {"slab": SLAB})):
        refs[f"ring_out_{mode}"] = np.asarray(jra.ring_attention_sharded(
            mesh, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    return refs


@pytest.fixture(scope="module")
def train_results(tmp_path_factory):
    return spawn("train", 4, tmp_path_factory.mktemp("train"))


@pytest.fixture(scope="module")
def layout_results(tmp_path_factory):
    return spawn("layouts", 4, tmp_path_factory.mktemp("layouts"),
                 refs=_ring_refs())


@pytest.fixture(scope="module", params=[2, 4])
def expert_results(request, tmp_path_factory):
    return spawn("experts", request.param,
                 tmp_path_factory.mktemp(f"experts{request.param}"))


def _hold(results, check, tol):
    assert check in results, sorted(results)
    if tol is None:
        assert results[check] == 1.0, (check, results[check])
    else:
        assert results[check] <= tol, (check, results[check], tol)


@pytest.mark.parametrize("check", TRAIN_CHECKS)
def test_train_step_over_four_ranks_matches_one(train_results, check):
    """DP (dropout, 2 microbatches, a ragged -100 tail), FSDP, the MoE GPT
    at a capacity that drops tokens (DP, and DP x EP over (2, 2)) and the
    MAE: two steps' losses within 1e-5 rel, parameters within 5e-5; the
    gathered optimizer state cut back to each rank's parts (a resume)
    gathers to itself exactly."""
    _hold(train_results, check, TRAIN[check.split("/")[1]])


@pytest.mark.parametrize("check", VQ_CHECKS)
def test_vq_vae_data_parallel_matches_one_rank(train_results, check):
    """A fresh SoundStream trained 3 steps (k-means on step 1, dead codes
    refreshed) over a data group of 4 ranks, of 2 (mesh (2, 2)) and of 4
    with 2 microbatches, against one rank on the same global batch (one
    window padded): each step's loss, logged perplexity and commit_loss,
    the parameters and the four codebook buffers within 1e-5 relative on
    every rank, and every rank's buffers bitwise rank 0's. No assignment
    near-tie showed at this size, so every code is compared."""
    _hold(train_results, check, VQ_TOL[check.split("/")[1]])


@pytest.mark.parametrize("check", sorted(EXPERT_TOL))
def test_expert_parallel_matches_unsharded(expert_results, check):
    """MoESwiGLU with its experts over 2 and 4 ranks: y, aux and every
    gradient against the whole layer; an MoE GPT's loss likewise."""
    _hold(expert_results, check, EXPERT_TOL[check])


@pytest.mark.parametrize("check", sorted(LAYOUT_TOL))
def test_layouts_over_four_ranks(layout_results, check):
    """TP x DP (LLaMA, FrankyLlama), GPT-2 TP (a GPT and a Franky, TP 2
    and TP 2 x DP 2, dropout 0 and 0.1: loss, logits and gradients within
    1e-5 rel, one AdamW step's parameters within 5e-5; a GPT and a LLaMA
    whose heads and vocabulary do not split kept whole where JAX
    replicates; serving a split GPT or LLaMA refused), GPipe and DP x PP,
    ring attention (full, causal, slab) with the seq_parallel encoder,
    and DP serving (greedy, beams, int8 KV, the submission strings)."""
    _hold(layout_results, check, LAYOUT_TOL[check])


@pytest.mark.parametrize("name,shape,rules,want", [
    ("llm_model.transformer.h.1.moe.w1", (4, 24, 96),
     shard_lib.MOE_EP_RULES, ("model", None, None)),
    ("w1", (4, 8, 16), shard_lib.MOE_EP_RULES, ("model", None, None)),
    ("llm_model.transformer.h.0.moe.wg", (24, 4), shard_lib.MOE_EP_RULES,
     ()),
    ("model.layers.0.self_attn.q_proj.weight", (32, 32),
     shard_lib.LLAMA_TP_RULES, ("model", None)),
    ("model.layers.0.mlp.down_proj.weight", (32, 64),
     shard_lib.LLAMA_TP_RULES, (None, "model")),
    ("model.embed_tokens.weight", (128, 32), shard_lib.LLAMA_TP_RULES,
     ("model", None)),
    ("model.norm.weight", (32,), shard_lib.LLAMA_TP_RULES, ()),
    ("transformer.h.0.attn.c_attn.weight", (72, 24),
     shard_lib.GPT2_TP_RULES, ("model", None)),
    ("transformer.h.0.mlp.c_proj.weight", (24, 96),
     shard_lib.GPT2_TP_RULES, (None, "model")),
    # whole models over a model group of ``shape`` ranks that does not
    # divide some dimensions: ``want`` the weights the port keeps whole
    ("gpt:n_head=3,n_embd=30,vocab_size=97", 4, shard_lib.GPT2_TP_RULES,
     {"attn.c_attn", "attn.c_proj", "wte"}),
    ("gpt:n_head=4,n_embd=32,vocab_size=98", 4, shard_lib.GPT2_TP_RULES,
     {"wte"}),
    ("llama:vocab_size=128", 3, shard_lib.LLAMA_TP_RULES,
     {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
      "down_proj", "embed_tokens", "lm_head"}),
    ("llama:n_kv_heads=4,hidden_dim=62,vocab_size=130", 4,
     shard_lib.LLAMA_TP_RULES,
     {"gate_proj", "up_proj", "down_proj", "embed_tokens", "lm_head"}),
])
def test_spec_for_matches_the_jax_rules(name, shape, rules, want):
    """The port's rules place each tensor where the JAX rules place its
    counterpart (the port's [out, in] weight is flax's kernel transposed,
    and its blocks are a list, not an [L] scan). For a whole model over a
    group that does not divide some of its dimensions, every weight the
    port keeps whole is one JAX's ``shard_params`` places as ``P()`` (its
    ``spec_for`` and divisibility guard), and every weight it splits JAX
    splits on the same axis."""
    from frankenstein_tpu.parallel import sharding as jshard
    if ":" in name:
        _whole_model_placement(name, shape, rules, want)
        return
    assert shard_lib.spec_for(name, shape, rules) == want
    jrules = {id(shard_lib.MOE_EP_RULES): jshard.MOE_EP_RULES,
              id(shard_lib.LLAMA_TP_RULES): jshard.LLAMA_TP_RULES,
              id(shard_lib.GPT2_TP_RULES): jshard.GPT2_TP_RULES}[id(rules)]
    jname = {"llm_model.transformer.h.1.moe.w1": "llm_model/h/moe/w1",
             "w1": "params/w1",
             "llm_model.transformer.h.0.moe.wg": "llm_model/h/moe/wg",
             "model.layers.0.self_attn.q_proj.weight":
                 "layers/q_proj/kernel",
             "model.layers.0.mlp.down_proj.weight": "layers/down_proj/kernel",
             "model.embed_tokens.weight": "embed",
             "model.norm.weight": "norm_f/weight",
             "transformer.h.0.attn.c_attn.weight": "h/c_attn/kernel",
             "transformer.h.0.mlp.c_proj.weight": "h/mlp_c_proj/kernel"}[name]
    jshape = tuple(reversed(shape)) if name.endswith("weight") and len(
        shape) == 2 and "embed" not in name else shape
    jspec = tuple(jshard.spec_for(jname, jshape, jrules))
    # the same tensor axis is split: flax kernels are [in, out]
    split = [i for i, a in enumerate(want) if a == "model"]
    jsplit = [i for i, a in enumerate(jspec) if a == "model"]
    if not split:
        assert not jsplit
    elif "moe" in name and name.count(".") > 1:
        assert jsplit == [1]            # [L, E, ...] in the JAX scan
    elif len(shape) == 2 and "embed" not in name:
        assert jsplit == [1 - split[0]]
    else:
        assert jsplit == split


def _jax_name(name: str) -> str:
    """The JAX package's parameter path of a port weight matched by a TP
    rule (the JAX blocks are one scanned ``h`` / ``layers`` stack)."""
    parts = name.split(".")
    if parts[-2] in ("wte", "embed_tokens", "lm_head"):
        return {"wte": "wte", "embed_tokens": "embed",
                "lm_head": "lm_head"}[parts[-2]]
    layer = parts[-2] if parts[-3] != "mlp" or parts[-2] != "c_proj" \
        else "mlp_c_proj"
    return f"{'h' if name.startswith('transformer') else 'layers'}/" \
           f"{layer}/kernel"


def _whole_model_placement(name, size, rules, want):
    from jax.sharding import Mesh

    from frankenstein_tpu.parallel import sharding as jshard
    from frankenstein_tpu_torch import config as tconfig
    from frankenstein_tpu_torch.models.gpt2 import GPT
    from frankenstein_tpu_torch.models.llama import Llama
    family, _, spec = name.partition(":")
    kw = {k: int(v) for k, v in (a.split("=") for a in spec.split(","))}
    model = (GPT(tconfig.GPTConfig(block_size=16, n_layer=2, **kw))
             if family == "gpt" else
             Llama(tconfig.tiny_llama_config(**kw)))
    plan = shard_lib.split_plan(model, size, rules)
    n_layer = 2
    tree = {}
    matched = {}
    for n, p in model.named_parameters(remove_duplicate=False):
        if shard_lib.rule_for(n, rules) is None:
            continue
        jname = _jax_name(n)
        shape = (tuple(p.shape) if "/" not in jname
                 else (n_layer,) + tuple(reversed(p.shape)))
        node = tree
        *path, leaf = jname.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.zeros(shape, np.float32)
        matched[n] = jname
    mesh = Mesh(np.asarray(jax.devices()[:size]).reshape(1, size),
                ("data", "model"))
    jrules = (jshard.GPT2_TP_RULES if rules is shard_lib.GPT2_TP_RULES
              else jshard.LLAMA_TP_RULES)
    placed = jshard.shard_params(mesh, tree, jrules)
    jspec = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        jspec["/".join(k.key for k in path)] = tuple(leaf.sharding.spec)
    whole = {n for n in matched if n not in plan}
    # a weight by its layer's name, a GPT's with its parent (two c_proj)
    label = lambda n: ".".join(n.split(".")[-3:-1]) if n.split(".")[-2] in (
        "c_attn", "c_proj", "c_fc") else n.split(".")[-2]
    assert {label(n) for n in whole} == want, sorted(whole)
    for n, jname in matched.items():
        split = [i for i, a in enumerate(jspec[jname]) if a == "model"]
        if n in whole:
            assert not split, (n, jname, jspec[jname])
        else:
            dim = plan[n][1]
            assert split == ([dim] if "/" not in jname
                             else [1 + (1 - dim)]), (n, jspec[jname])


@pytest.mark.parametrize("shape,size,min_size", [
    ((64, 16), 4, 256), ((8, 4), 4, 256), ((6, 10), 4, 16),
    ((1024, 96), 8, 2 ** 16), ((96, 1024), 2, 2 ** 16), ((7, 9), 2, 1)])
def test_fsdp_spec_matches_the_jax_rule(shape, size, min_size):
    from frankenstein_tpu.parallel import sharding as jshard

    class _Mesh:                      # fsdp_spec reads mesh.shape only
        pass
    m = _Mesh()
    m.shape = {"data": size}
    want = tuple(jshard.fsdp_spec(shape, m, min_size))
    assert shard_lib.fsdp_spec(shape, size, min_size) == want


@pytest.fixture(scope="module")
def dryrun_out():
    from frankenstein_tpu_torch.dryrun import dryrun
    return dryrun(4, "cpu", timeout=240.0)


@pytest.mark.parametrize("phase", [
    "DP ok", "TPxDP (2,2) ok", "DPxPP (1,4) ok", "SP ring-attention (seq=4) ok",
    "EP MoE (experts over model=2) ok", "FSDP (", "FrankyLlama TPxDP (2,2) ok"])
def test_dryrun_prints_its_ok_lines(dryrun_out, phase):
    """``python -m frankenstein_tpu_torch.dryrun --ranks 4 --device cpu``:
    the seven phases of the JAX dryrun_multichip, each with a finite
    loss."""
    lines = [l for l in dryrun_out.splitlines()
             if l.startswith("dryrun_multichip(4): " + phase)]
    assert len(lines) == 1, dryrun_out
    assert "ok, loss=" in lines[0]

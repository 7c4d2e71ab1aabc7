"""The system under test, reached from the benchmark: the port
``repro_torch`` under ``src/`` of the checkout.

The harness reaches the port through this module (and the faults it
plants, ``faults.py``).  It turns a configuration file into the port's
``ModelConfig``, prunes and packs the params tree that the
configuration's reference lays the benchmark's weights out as, through
the port's serving path (``sparse.knapsack_prune`` then
``sparse.pack_params``, as ``launch.serve.build_params`` does), builds
the port's ``ServingEngine``, builds what ``launch.train.prune`` builds
for Algorithm 2 (:func:`algorithm2`), and turns the port's own tracer
(``repro_torch.tracing``) on and off around a traced run's window.
"""
from __future__ import annotations

import sys
from typing import Dict, Tuple

from .spec import PLAN_KEYS, ROOT, layer_plan

# configuration-file key -> the port's ModelConfig field
FIELDS = {
    "hidden_size": "d_model",
    "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "kv_heads",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab",
    "rope_theta": "rope_theta",
    "tie_word_embeddings": "tie_embeddings",
    "num_local_experts": "moe_experts",
    "num_experts_per_tok": "moe_top_k",
    "qkv_bias": "qkv_bias",
    "param_dtype": "param_dtype",
    "activ_dtype": "activ_dtype",
    "capacity_factor": "capacity_factor",
    "num_experts": "moe_experts",
    "head_dim": "head_dim",
    "use_rope": "use_rope",
    "sliding_window": "window",
    "mamba_d_state": "d_state",
    "mamba_d_conv": "d_conv",
}
PORT_RMS_EPS = 1e-6       # models/layers.rmsnorm's eps
# sizes the port fixes by a rule of its own (models/mamba.py mamba_init):
# configuration-file key -> the size the rule gives for hidden size d
FIXED = {
    "mamba_expand": lambda d: 2,
    "mamba_dt_rank": lambda d: max(d // 16, 1),
}
# numbers of a configuration file that are no size of the port's model:
# key -> what the harness does with it
READ = {
    "rms_norm_eps": "checked against the port's RMSNorm eps",
    "max_position_embeddings": "a bound the traffic's lengths stay within",
    "num_logits_to_keep": "the engine keeps the last position's logits only",
}


def import_port():
    """Put the checkout's ``src`` first on the path; import nothing yet."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def port_config(cfg: Dict):
    """The port's ModelConfig of configuration file ``cfg``: the port's
    own entry for ``cfg["port_arch"]`` with every size of the file (and
    each assumed size) set on it.  A file without ``use_rope`` keeps
    RoPE.  Raises where the file states a size the port has no field
    for (a number other than 0, at the top level or under ``assumed``,
    that no key of :data:`FIELDS`, :data:`FIXED`,
    :data:`~portbench.spec.PLAN_KEYS` or :data:`READ` names), or one that
    differs from a rule the port fixes (:data:`FIXED`),
    and where the entry's layers (``layer_specs``) differ, layer by
    layer, from the file's :func:`~portbench.spec.layer_plan`: the
    entry's mixer and MLP patterns are the port's, and a file cannot
    make the port run a stack that no entry of it ships."""
    import_port()
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_specs
    if float(cfg["rms_norm_eps"]) != PORT_RMS_EPS:
        raise ValueError(f"the port's RMSNorm eps is {PORT_RMS_EPS}, the "
                         f"configuration states {cfg['rms_norm_eps']}")
    sizes = {**cfg, **cfg.get("assumed", {})}
    known = {*FIELDS, *FIXED, *PLAN_KEYS, *READ}
    stated = [key for key, v in sizes.items() if key not in known
              and isinstance(v, (int, float)) and not isinstance(v, bool) and v]
    if stated:
        raise ValueError(f"the port has no field for {stated}")
    for key, rule in FIXED.items():
        if key in sizes and sizes[key] != rule(sizes["hidden_size"]):
            raise ValueError(f"the port fixes {key} at {rule(sizes['hidden_size'])}, "
                             f"the configuration states {sizes[key]}")
    kw = {field: sizes[key] for key, field in FIELDS.items() if key in sizes}
    model_cfg = get_config(cfg["port_arch"]).replace(**kw)
    ported = [(s.mixer, s.mlp) for s in layer_specs(model_cfg)]
    plan = layer_plan(cfg)
    if ported != plan:
        wrong = [i for i, (a, b) in enumerate(zip(ported, plan)) if a != b]
        raise ValueError(f"the port's {cfg['port_arch']} runs layers "
                         f"{ported}, the configuration states {plan} (they "
                         f"differ at layers {wrong or 'count'})")
    return model_cfg


def pack(params: Dict, cfg: Dict) -> Tuple[Dict, Dict]:
    """The port's serving set-up of the weights: one knapsack at the
    configured sparsity over the attention, MLP and expert matrices,
    then BSR packing.  Returns (packed params, the port's summary)."""
    import_port()
    from repro_torch.core import BlockingSpec
    from repro_torch.sparse import knapsack_prune, pack_params, sparsity_summary
    pr = cfg["pruning"]
    sel = knapsack_prune(params, sparsity=float(pr["sparsity"]),
                         blocking=BlockingSpec(bk=pr["block"][0], bn=pr["block"][1]),
                         min_size=int(pr["min_size"]))
    packed = pack_params(params, sel.masks, sel.structures)
    summ = sparsity_summary(packed)
    summ.update(kept=sel.kept, total=sel.total, method=sel.result.method)
    return packed, summ


def engine(packed: Dict, model_cfg, traffic: Dict, seed: int, device):
    """The port's serving engine as the traffic file configures it."""
    import_port()
    from repro_torch.serving import ServingEngine
    e = traffic["engine"]
    return ServingEngine(packed, model_cfg, num_slots=e["num_slots"],
                         page_size=e["page_size"], max_seq_len=e["max_seq_len"],
                         ticks_per_sync=e["ticks_per_sync"],
                         prefix_caching=e["prefix_caching"],
                         seed=seed & 0x7FFFFFFF, device=device)


def build_kernels(device) -> float:
    """Build the port's CUDA kernels into its build directory in the
    checkout (only what is missing); seconds spent."""
    if device.type != "cuda":
        return 0.0
    import_port()
    from repro_torch.kernels import _build
    return _build.build_all()


def tracer_on() -> None:
    """The port's tracer on, with nothing recorded before."""
    import_port()
    from repro_torch import tracing
    tracing.drain()
    tracing.enable()


def tracer_off() -> Dict:
    """The port's tracer off; what it recorded since :func:`tracer_on`
    (``{"spans": [...], "counters": {...}}``)."""
    from repro_torch import tracing
    tracing.disable()
    return tracing.drain()


def leaf_name(path: str) -> str:
    """The benchmark's name of the port's params leaf ``path``:
    ``layers/3/attn/wq/kernel`` -> ``wq/3``, ``.../wq/bias`` -> ``bq/3``,
    ``layers/3/pre_norm/scale`` -> ``pre_norm/3``, ``layers/3/mlp/w_up/
    kernel`` -> ``w_up/3``, ``layers/3/moe/experts_up`` -> ``experts_up/3``,
    ``embed/embedding`` -> ``embed``, ``final_norm/scale`` -> ``final_norm``."""
    parts = path.split("/")
    if parts[0] != "layers":
        return parts[0]
    layer, rest = parts[1], parts[2:]
    if rest[-1] == "bias":
        return f"b{rest[-2][1:]}/{layer}"
    name = rest[-2] if rest[-1] in ("kernel", "scale") else rest[-1]
    if rest[0] in ("pre_norm", "post_norm"):
        name = rest[0]
    return f"{name}/{layer}"


def leaf_norms(tree, minus=None) -> Dict[str, float]:
    """fp32 L2 norm of every leaf of a port tree (less the same leaf of
    ``minus``, a tree of the same layout), by :func:`leaf_name`."""
    import_port()
    import torch
    from repro_torch.core.structures import iter_leaves
    out = {}
    others = iter_leaves(minus) if minus is not None else None
    for p, t in iter_leaves(tree):
        t = t.to(torch.float32)
        if others is not None:
            q, u = next(others)
            if q != p:
                raise ValueError(f"trees differ at {p} / {q}")
            t = t - u.to(torch.float32)
        out[leaf_name(p)] = float(torch.linalg.vector_norm(t))
    return out


def algorithm2(params: Dict, model_cfg, job: Dict, batches, device) -> Dict:
    """What ``launch.train.prune`` builds for Algorithm 2, over the
    benchmark's ``batches`` (the fine-tune's, then the eval's) in place
    of its pipeline: the structures (``prune_structures``: every matmul
    weight of at least 4096 elements in 128 x 128 tiles, the embedding
    included), the ``IterativePruner`` with the bf16 ``TPUResourceModel``
    and ``constant_step`` schedule, the graphed fine-tune step
    (``train_step_for``, warm-up then cosine at a third of the learning
    rate) on fresh AdamW state, and the eval loss.  The job file gives
    the target, the schedule's step, the tolerance, the fine-tune's
    learning-rate schedule and AdamW's settings (the launcher's)."""
    import_port()
    from repro_torch.core import (IterativePruner, PruneConfig, TPUResourceModel,
                                  apply_masks, constant_step)
    from repro_torch.launch.train import FINETUNE_STEPS, prune_structures
    from repro_torch.models import cross_entropy_loss, lm_forward
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import init_train_state, train_step_for
    import torch

    if len(batches) != FINETUNE_STEPS + 1:
        raise ValueError(f"the port fine-tunes {FINETUNE_STEPS} steps an "
                         f"iteration: {len(batches)} batches given")
    pruner = IterativePruner(
        prune_structures(params),
        TPUResourceModel(precision=("bf16" if model_cfg.param_dtype == "bfloat16"
                                    else "fp32")),
        PruneConfig(schedule=constant_step([job["target"]] * 2, job["schedule_step"]),
                    tolerance=job["tolerance"], higher_is_better=False))
    opt_cfg = AdamWConfig(use_master=model_cfg.param_dtype != "float32",
                          **job["adamw"])
    lr = job["finetune_schedule"]
    fstep = train_step_for(model_cfg, opt_cfg,
                           warmup_cosine(lr["peak"], lr["warmup"], lr["total"]), device,
                           what="fine-tune step")
    eval_batch = batches[-1]

    @torch.no_grad()
    def eval_loss(p, masks):
        logits, _ = lm_forward(apply_masks(p, masks), eval_batch, model_cfg)
        return float(cross_entropy_loss(logits, eval_batch["labels"]))

    def fresh_state(p, masks):
        return init_train_state(p, opt_cfg, masks=masks)

    return {"pruner": pruner, "fstep": fstep, "eval": eval_loss,
            "fresh_state": fresh_state, "opt": opt_cfg, "steps": FINETUNE_STEPS}

"""Before-execute-time AT driver: distribution-layout selection per
(arch x shape x mesh), the paper's ``static select according estimated``.

Basic parameters (the paper's BP concept): arch name, seq_len,
global_batch, mesh shape.  Performance parameter: the layout plan.  The
cost definition function is the three-term roofline (``core/cost.py``'s
``roofline_terms``) over :func:`repro_torch.launch.analytic.step_costs`
and a per-plan collective model, at one card's rates: the row of
``core.cost.CHIPS`` named by ``chip`` (``torch.cuda.get_device_name()``),
the default row (the H100 SXM) when it is None.  The measured path,
``compiled_plan_cost``, scores a candidate by the port's dry run of it
(:func:`repro_torch.launch.dryrun.dryrun_cell`: one step on fake tensors
over the production mesh, its per-rank FLOPs and collective bytes
counted) through the roofline of :mod:`repro_torch.launch.roofline`.

Results are recorded per BP tuple in ``OAT_StaticParam.dat`` exactly like
the paper's ``(OAT_PROBSIZE 1024 (MyMatMul_I 4) ...)`` records, with the
same region names and BPs as the JAX package's.
"""
from __future__ import annotations

from typing import Callable

from .. import at
from ..configs import get_arch, get_shape
from ..core import ATContext
from ..core.cost import DEFAULT_CHIP, chip_spec, roofline_terms
from ..launch.analytic import step_costs

TRAIN_PLANS = ("tp", "fsdp")
DECODE_PLANS = ("tp", "decode_seq", "decode_resident")


def candidate_plans(kind: str) -> tuple[str, ...]:
    return DECODE_PLANS if kind == "decode" else TRAIN_PLANS


def analytic_plan_cost(arch_name: str, shape_name: str, plan: str,
                       chips: int = 256, model_axis: int = 16,
                       chip: str | None = None) -> float:
    """Roofline bound (s) for one layout plan, fully analytic, at the
    rates of ``chip_spec(chip)`` (the default row when ``chip`` is None).

    Collective model per plan (bytes per step, whole mesh):
    * tp      — per-layer activation all-reduce on the model axis
                (2 x hidden per layer, both matmul families) + grad
                reduce-scatter (train);
    * fsdp    — per-layer weight all-gather (layer params / model axis)
                + grad reduce-scatter;
    * decode_seq — LSE merge all-reduce over the model axis per layer
                (tiny) + cache stays put.
    """
    spec = chip_spec(DEFAULT_CHIP if chip is None else chip)
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    ana = step_costs(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    t = b * (1 if shape.kind == "decode" else s)
    d = cfg.d_model
    data_axis = max(chips // model_axis, 1)
    layer_params = (cfg.param_count()
                    - cfg.padded_vocab * d * (1 if cfg.tie_embeddings
                                              else 2)) / max(cfg.n_layers, 1)
    bf16 = 2
    compute_scale = 1.0
    mem_scale = 1.0
    if plan == "tp":
        # activation all-reduce on the model axis, per matmul family
        coll = 2 * t * d * bf16 * cfg.n_layers * 2
        if shape.kind == "decode" and cfg.ssm_version == 0 \
                and cfg.n_kv_heads % model_axis != 0:
            # KV cache cannot shard over model: cache reads replicate
            mem_scale = float(model_axis)
    elif plan == "fsdp":
        # per-layer weight all-gather; model axis does replicated compute
        coll = layer_params * bf16 * cfg.n_layers * (model_axis - 1) \
            / model_axis
        compute_scale = float(model_axis)
    elif plan == "decode_resident":
        # weights resident on the model axis: per-layer activation
        # all-reduce only; no weight gather ever
        coll = 2 * t * d * bf16 * cfg.n_layers * 2
    else:  # decode_seq: seq-sharded cache + LSE-merge all-reduce (tiny)
        coll = 2 * t * cfg.n_heads * (cfg.head_dim + 2) * 4 * cfg.n_layers
    if shape.kind == "decode" and plan != "decode_resident":
        # weights FSDP-sharded over data are re-gathered every step
        coll += layer_params * bf16 * cfg.n_layers * (data_axis - 1) \
            / data_axis
    if shape.kind == "train":
        coll += cfg.param_count() * 4          # grad reduce-scatter fp32
        if plan == "fsdp":
            coll += layer_params * bf16 * cfg.n_layers  # bwd re-gather
    terms = roofline_terms(ana.flops * compute_scale,
                           ana.bytes * mem_scale, coll, chips,
                           peak_flops=spec.peak_flops_bf16,
                           hbm_bw=spec.hbm_bw, ici_bw=spec.link_bw)
    # rank by the un-overlapped sum: plans that tie on the dominant term
    # still separate on the terms they actually change
    return terms.compute_s + terms.memory_s + terms.collective_s


def compiled_plan_cost(arch_name: str, shape_name: str, plan: str,
                       multi_pod: bool = False, **overrides) -> float:
    """The measured path: the roofline bound (s) of the port's dry run of
    the candidate (``from_artifact(dryrun_cell(...)).bound_s``, as the
    JAX package's); ``overrides`` go to ``dryrun_cell`` (``remat``,
    ``num_microbatches``, ``loss_chunks``)."""
    from ..launch.dryrun import dryrun_cell
    from ..launch.roofline import from_artifact
    rec = dryrun_cell(arch_name, shape_name, multi_pod=multi_pod,
                      plan_name=plan, verbose=False, **overrides)
    return from_artifact(rec).bound_s


def tune_layout(session: "at.AutoTuner | ATContext", arch_name: str,
                shape_name: str,
                cost_fn: Callable[[str], float] | None = None,
                chips: int = 256, chip: str | None = None) -> str:
    """Static-AT select over layout plans; returns the winner and records
    it in the FIBER store + static param file + the session record store
    (so a later process skips the selection for an already-tuned cell).
    Without ``cost_fn`` each plan costs :func:`analytic_plan_cost` at
    ``chip``'s rates."""
    session = at.AutoTuner.for_context(session)
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    plans = candidate_plans(shape.kind)
    cost_fn = cost_fn or (
        lambda p: analytic_plan_cost(arch_name, shape_name, p, chips,
                                     chip=chip))

    region_name = f"Layout_{arch_name}_{shape_name}".replace("-", "_") \
        .replace(".", "_")
    sel = session.autotune("static", "select", name=region_name,
                           params=["bp OAT_PROBSIZE", "bp OAT_NUMPROCS"])
    for p in plans:
        cost = cost_fn(p)
        sel.alternative(according=f"estimated {cost!r}", name=p)(
            lambda p=p: p)

    if not session.ctx.store.has_default_bps():
        session.set_bps(numprocs=chips, start=shape.seq_len,
                        end=shape.seq_len, dist=max(shape.seq_len, 1))
    session.ctx.phase_ran["install"] = True   # layout AT has no install deps
    session.run("static", [region_name])
    best = session.best(region_name)
    idx = int(best.get(f"{region_name}_SELECT", 0))
    return plans[idx]


def tune_all_layouts(session: "at.AutoTuner | ATContext", cells,
                     cost_fn=None, chip: str | None = None) -> dict:
    """:func:`tune_layout` over ``cells`` ((arch, shape) names) in one
    session: {(arch, shape): plan}."""
    session = at.AutoTuner.for_context(session)
    out = {}
    for arch_name, shape_name in cells:
        out[(arch_name, shape_name)] = tune_layout(
            session, arch_name, shape_name, cost_fn, chip=chip)
    return out

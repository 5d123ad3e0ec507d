"""One rank of the two-rank tensor-parallel tests: a gloo world of two
processes (``file://`` store, no port opened) over the mesh (data 1,
model 2), each rank holding its pieces of the params by the reference's
``_TP_RULES``. Every check runs the port twice on the same inputs, over
the mesh and whole on the rank (no mesh), and writes both to an ``.npz``
for ``tests/test_torch_tp.py`` to compare, which also holds the mesh's run
against the JAX package's on the same params and batches (``INPUTS.npz``,
written by the test: params as numpy leaves and numpy-seeded batches).
Imports torch and the port only. Run as a subprocess a rank:

    python tests/torch_tp_ranks.py RANK INIT INPUTS.npz OUT.npz
"""

import datetime
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import CompressionConfig, resolve  # noqa: E402
from repro_torch.core.state import ClientState  # noqa: E402
from repro_torch.dist import sharding as shr  # noqa: E402
from repro_torch.dist import step as dstep  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.utils import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.utils.convert import from_jax_params  # noqa: E402
from repro_torch.utils.flat import FlatLayout  # noqa: E402

WORLD = 2
# the families the four-rank JAX cases do not cover, at smoke size
ARCHS = ("mamba2-780m", "recurrentgemma-9b", "musicgen-large", "qwen2-vl-72b", "qwen2.5-3b")
BATCH, SEQ, DECODE = 2, 16, 4
# the group select's tree: leaf -> (whole shape, the dim cut over the two
# ranks or None); "a" and "c" are cut so that a rank's piece is strided in
# the leaf's flat order
SELECT = {"a": ((64, 32), 1), "b": ((40,), None), "c": ((8, 128), 0), "d": ((5,), None),
          "e": ((96,), 0)}
ROWS = 3
RATES = (0.1, 0.37)
# the compression stages' tree (ROADMAP item 11 part C2b): "a"'s sample
# strides (2, 1, 1) fall across its cut (rank 1's piece starts at row 3),
# "c" and "f" are cut along columns (a rank's piece strided in the leaf's
# flat order, each 256-entry block of the whole leaf straddling both ranks)
STAGES = {"a": ((6, 7, 1000), 0), "b": ((40,), None), "c": ((96, 500), 1), "d": ((300,), 0),
          "e": ((5,), None), "f": ((20, 900), 1)}
# the compositions test_torch_tp.py's test_stages_over_a_model_axis names:
# those that acted elementwise or per leaf before ROADMAP item 11 part C2b,
# and the eight that cut or key a leaf by flat coordinate
ALLOWED = [dict(scheme=s) for s in ("dgc", "gmc", "dgcwgm", "dgcwgmf")] + [
    dict(scheme="dgcwgmf", use_kernels=True), dict(scheme="dgcwgmf", downlink_stage="topk"),
    dict(scheme="dgc", wire_dtype="float16"), dict(scheme="dgcwgmf", wire_dtype="bfloat16")]
REFUSED = [dict(scheme="dgcwgmf", selector="sampled"), dict(scheme="dgc", per_tensor=False),
           dict(scheme="randomk"), dict(scheme="fetchsgd"), dict(scheme="dgc", wire_stage="int8"),
           dict(scheme="dgc", wire_stage="probquant"),
           dict(scheme="dgc", rotation_stage="hadamard"), dict(scheme="adaptive_dgcwgmf")]


def kw_id(kw) -> str:
    return ",".join(f"{k}={v}" for k, v in kw.items())


# every composition above, and the cut stages' other paths (the fused
# sampled estimator, adaptive rates with the sampled and global selectors,
# the top-k downlink's global, sampled, int8 and probquant variants), by name;
# the adaptive ones run with per-client rates and wire levels
STAGE_CASES = {kw_id(kw): kw for kw in ALLOWED + REFUSED} | {
    "sampled_fused": dict(scheme="dgcwgmf", selector="sampled", use_kernels=True),
    "adaptive_sampled": dict(scheme="adaptive_dgcwgmf", selector="sampled"),
    "adaptive_global": dict(scheme="adaptive_dgcwgmf", per_tensor=False),
    "dl_global": dict(scheme="dgcwgmf_dl", per_tensor=False),
    "dl_sampled": dict(scheme="dgcwgmf_dl", selector="sampled"),
    "dl_int8": dict(scheme="dgcwgmf_dl", wire_stage="int8"),
    "dl_probquant": dict(scheme="dgcwgmf_dl", wire_stage="probquant"),
}
ADAPTIVE = (kw_id(dict(scheme="adaptive_dgcwgmf")), "adaptive_sampled", "adaptive_global")
# the engine at (1, 2): llama's smoke cuts its 2 kv heads one a rank, yi-34b's
# keeps its one kv head whole (the projections gathered); both codecs
ENGINE_ARCHS = ("llama3.2-1b", "yi-34b")
ENGINE_WIRES = ("float32", "int8")


def batch_of(cfg, seed):
    """A numpy-seeded batch as numpy arrays: tokens (B, T), audio (B, K, T);
    vlm adds patch embeddings (B, P, d) and -1 labels over the patches."""
    rng = np.random.default_rng(seed)
    shape = (BATCH, cfg.num_codebooks, SEQ) if cfg.family == "audio" else (BATCH, SEQ)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, -1)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(size=(BATCH, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
        batch["labels"] = np.concatenate([np.full((BATCH, cfg.num_patches), -1, np.int32),
                                          batch["labels"]], axis=1)
    return batch


def decode_pos(cfg) -> int:
    """The first decode step's position: after the prompt (and the patches)."""
    return SEQ + (cfg.num_patches if cfg.family == "vlm" else 0)


def families(mesh, inp, out):
    """Loss, gradients, a prefill and DECODE greedy steps of each arch over
    the mesh and whole (the gradients' whole side cut to the rank's pieces),
    from the params and the batch in ``inp``."""
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)
        like = transformer.abstract_params(cfg)
        n = len(tree_leaves(like))
        whole = from_jax_params(tree_unflatten(like, [inp[f"{arch}/param/{i}"] for i in range(n)]),
                                layout="transformer")
        sh = shr.named_shardings(mesh, shr.param_specs(whole, fsdp=False, mesh=mesh))
        local = shr.local_tree(whole, sh)
        out[f"{arch}/cut"] = np.asarray([a.numel() != b.numel() for a, b in zip(
            tree_leaves(local), tree_leaves(whole), strict=True)])
        batch = {k[len(arch) + 7:]: torch.from_numpy(v).long() if v.dtype == np.int32
                 else torch.from_numpy(v) for k, v in inp.items()
                 if k.startswith(f"{arch}/batch/")}
        for tag, params, m in (("tp", local, mesh), ("one", whole, None)):
            (loss, _), grads = dstep._value_and_grad(dstep.make_loss_fn(cfg, m), params, batch)
            if m is None:
                grads = shr.local_tree(grads, sh)
            out[f"{arch}/{tag}/loss"] = loss.numpy()
            for i, g in enumerate(tree_leaves(grads)):
                out[f"{arch}/{tag}/grad/{i}"] = g.numpy()
            prompt = {k: v for k, v in batch.items() if k != "labels"}
            logits, cache = dstep.make_prefill_step(cfg, m, cache_len=SEQ + DECODE)(params,
                                                                                     prompt)
            out[f"{arch}/{tag}/prefill"] = logits.numpy()
            serve = dstep.make_serve_step(cfg, m)
            tok = torch.argmax(logits, dim=-1)
            pos = torch.tensor(decode_pos(cfg))
            for t in range(DECODE):
                tok, logits, cache = serve(params, cache, tok, pos + t)
                out[f"{arch}/{tag}/decode/{t}"] = logits.numpy()
                out[f"{arch}/{tag}/token/{t}"] = tok.numpy()


def clipped(mesh, out):
    """One dense step of llama with the optimiser's global-norm clip (and
    momentum and weight decay) over the mesh and whole: the whole params
    after it."""
    from repro_torch.configs.base import TrainConfig

    cfg = configs.get_smoke("llama3.2-1b")
    whole = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    sh = shr.named_shardings(mesh, shr.param_specs(whole, fsdp=False, mesh=mesh))
    tcfg = TrainConfig(learning_rate=0.05, total_steps=4, grad_sync="dense", grad_clip=0.5,
                       momentum=0.9, weight_decay=0.01)
    batch = {k: torch.from_numpy(v).long() for k, v in batch_of(cfg, 2).items()}
    ccfg = CompressionConfig()
    for tag, params, m in (("tp", shr.local_tree(whole, sh), mesh), ("one", whole, None)):
        state = dstep.init_train_state(cfg, tcfg, ccfg, params, m)
        step = dstep.make_train_step(cfg, tcfg, ccfg, m)
        for _ in range(2):
            state, met = step(state, batch)
        final = shr.full_tree(state.params, sh) if m is not None else state.params
        for i, x in enumerate(tree_leaves(final)):
            out[f"clip/{tag}/{i}"] = x.numpy()
        out[f"clip/{tag}/total"] = met["total_params"].numpy()


def engine(mesh, out):
    """The continuous-batching engine over the mesh (each rank its pieces of
    the params and of the pool) and the one-rank engine on the whole params:
    every request's tokens, and the kv heads a rank's pool holds."""
    from repro_torch.serve import ServeConfig, ServeEngine

    shape = dict(max_slots=2, page_size=8, pages_per_slot=4, prompt_pad=16, max_new_tokens=4)
    prompts = [np.arange(3 + 2 * i, dtype=np.int32) * (i + 5) % 97 for i in range(3)]
    for arch in ENGINE_ARCHS:
        cfg = configs.get_smoke(arch)
        whole = transformer.init_params(cfg, torch.Generator().manual_seed(0))
        local = shr.local_tree(whole, shr.named_shardings(
            mesh, shr.param_specs(whole, fsdp=False, mesh=mesh)))
        for wire in ENGINE_WIRES:
            sc = ServeConfig(**shape, wire=wire)
            for tag, params, m in (("tp", local, mesh), ("one", whole, None)):
                eng = ServeEngine(cfg, params, sc, mesh=m)
                for i, p in enumerate(prompts):
                    eng.submit(p, arrival_tick=i)
                done, _ = eng.run()
                out[f"engine/{arch}/{wire}/{tag}"] = np.concatenate(
                    [np.asarray(c.tokens).reshape(-1) for c in done])
                out[f"engine/{arch}/{wire}/{tag}/kv"] = np.asarray(
                    eng.pool["groups"][0]["k"].shape[-2])


def pieces(whole, r, leaves=SELECT):
    """Rank ``r``'s pieces of ``leaves``' ([rows, *shape] each)."""
    out = {}
    for k, (_, dim) in leaves.items():
        x = whole[k]
        out[k] = x if dim is None else x.chunk(WORLD, dim=dim + 1)[r].contiguous()
    return out


def select(group, out):
    """The plain group select over the model group against the one-rank
    select on the whole leaves: both modes, keep counts from the whole
    sizes, integer-valued v and m (their norms exact in any summation
    order) with ties spanning both ranks, and the fused compression's
    payload and counts through ``Scheme.client_compress``."""
    r = dist.get_rank(group)
    rng = np.random.default_rng(5)
    whole_shapes = {k: (ROWS, *s) for k, (s, _) in SELECT.items()}

    def draw():
        return {k: torch.from_numpy(rng.integers(-6, 7, size=s).astype(np.float32))
                for k, s in whole_shapes.items()}

    v, m, u = draw(), draw(), draw()
    big = FlatLayout.of({k: x[0] for k, x in v.items()})
    small = FlatLayout.of({k: x[0] for k, x in pieces(v, r).items()})
    lay = small.over(group, big.sizes)
    out["select/cut"] = np.asarray(lay.cut_flags)
    flat = lambda tree, layout: layout.flatten(tree)  # noqa: E731
    cut_flat = lambda tree: flat(pieces(tree, r), small)  # noqa: E731
    w = torch.ones(ROWS)
    tau = torch.full((ROWS,), 0.4)
    for rate in RATES:
        out[f"select/{rate}/keep"] = np.asarray([lay.keep(rate)[0], big.keep(rate)[0]])
        got = ops.gmf_select(cut_flat(v), cut_flat(m), lay, rate, w=w, tau=tau, eps=1e-16)
        want = ops.gmf_select(flat(v, big), flat(m, big), big, rate, w=w, tau=tau, eps=1e-16)
        for name, a, b in zip(("inv_nv", "inv_nm", "thr"), got, want, strict=True):
            out[f"select/{rate}/{name}"] = np.stack([a.numpy(), b.numpy()])
        g_loc = ops.gmf_compress(cut_flat(u), cut_flat(v), cut_flat(m), layout=lay,
                                 inv_norm_v=got[0], inv_norm_m=got[1], tau=tau,
                                 threshold=got[2])
        g_all = ops.gmf_compress(flat(u, big), flat(v, big), flat(m, big), layout=big,
                                 inv_norm_v=want[0], inv_norm_m=want[1], tau=tau,
                                 threshold=want[2])
        mask_whole = big.unflatten(g_all[3])
        out[f"select/{rate}/mask"] = np.stack([g_loc[3].numpy(),
                                               cut_flat(mask_whole).numpy()])
        out[f"select/{rate}/nnz"] = np.stack([lay.nnz(g_loc[3]).numpy(),
                                              big.nnz(g_all[3]).numpy()])
        # |z| mode on ties (quarter steps), as the staged path and the downlink use it
        z = {k: x * 0.25 for k, x in draw().items()}
        thr, mask = ops.topk_abs_select(cut_flat(z), lay, rate)
        thr_w, mask_w = ops.topk_abs_select(flat(z, big), big, rate)
        out[f"select/{rate}/abs_thr"] = np.stack([thr.numpy(), thr_w.numpy()])
        out[f"select/{rate}/abs_mask"] = np.stack([mask.numpy(),
                                                   cut_flat(big.unflatten(mask_w)).numpy()])
        out[f"select/{rate}/abs_nnz"] = np.stack([lay.nnz(mask).numpy(),
                                                  big.nnz(mask_w).numpy()])
    # the fused compression of dgcwgmf through the scheme, each rank its pieces
    # of a row
    scheme = resolve(CompressionConfig(scheme="dgcwgmf", rate=RATES[0], tau=0.4,
                                       use_kernels=True))
    # (u and m zero and an integer broadcast: the updated v and m are
    # integers, their norms exact)
    runs = []
    grad, gbar = draw(), draw()
    zero = {k: torch.zeros_like(x) for k, x in u.items()}
    for layout, cut in ((lay, cut_flat), (big, lambda t: flat(t, big))):
        state = ClientState(u=cut(zero), v=cut(v), m=cut(zero))
        g, _, info = scheme.client_compress(state, cut(grad), cut(gbar)[0], 0, layout=layout)
        runs.append((g, info))
    out["scheme/payload"] = np.stack([runs[0][0].numpy(),
                                      cut_flat(big.unflatten(runs[1][0])).numpy()])
    out["scheme/nnz"] = np.stack([runs[0][1].upload_nnz.numpy(),
                                  runs[1][1].upload_nnz.numpy()])
    out["scheme/total"] = np.asarray([runs[0][1].total_params, runs[1][1].total_params])


def stage_case(group, name, out):
    """One configuration of STAGE_CASES through ``client_compress`` and
    ``server_aggregate`` on the rank's pieces over the model group (the
    layout ``over`` it with each piece's box), on the whole leaves (no
    group), and on the pieces taken for whole leaves (the piece-local
    version: local indices, blocks, samples and top-k): each output of the
    first two as the rank's pieces, and the third's payload and broadcast.
    Integer-valued inputs in [-6, 6] under GMF, so that every norm is exact
    in any summation order, normal draws elsewhere (where the piece-local
    top-k threshold of integers would be the whole row's: 6); the sketch
    sums its buckets in another order over the ranks, so its server side
    also runs on the whole run's summed sketch, whose hitters are then the
    whole's bit for bit."""
    from repro_torch.core.state import ServerState
    from repro_torch.utils.flat import Box

    r = dist.get_rank(group)
    rng = np.random.default_rng(11)
    shapes = {k: (ROWS, *s) for k, (s, _) in STAGES.items()}

    cfg = CompressionConfig(rate=0.1, downlink_rate=0.1, **STAGE_CASES[name])
    scheme = resolve(cfg)
    ints = scheme.fusion.name == "gmf"

    def draw():
        return {k: torch.from_numpy((rng.integers(-6, 7, size=s) if ints else
                                     rng.normal(size=s)).astype(np.float32))
                for k, s in shapes.items()}

    big = FlatLayout.of({k: torch.zeros(s) for k, (s, _) in STAGES.items()})
    small = FlatLayout.of({k: x[0] for k, x in pieces(draw(), r, STAGES).items()})
    # every rank's pieces' boxes, in rank order
    places = [(None, [Box(s, tuple(q * (n // WORLD) if j == d else 0 for j, n in enumerate(s)))
                      for _, (s, d) in sorted(STAGES.items())]) for q in range(WORLD)]
    lay = small.over(group, big.sizes, places)
    u, v, m, res, smom, grad, gbar = (draw() for _ in range(7))
    kw = dict(client_ids=torch.tensor([3, 8, 1]))
    if name in ADAPTIVE:
        kw.update(rates=torch.tensor([0.05, 0.2, 0.5]), wire_levels=torch.tensor([0, 1, 0]))
    whole_flat = lambda t: big.flatten(t)  # noqa: E731
    cut_flat = lambda t: small.flatten(pieces(t, r, STAGES))  # noqa: E731
    to_piece = lambda x: small.flatten(pieces(big.unflatten(x), r, STAGES))  # noqa: E731
    sketch_zero = {"s_mom": torch.zeros(cfg.sketch_rows, cfg.sketch_cols),
                   "s_err": torch.zeros(cfg.sketch_rows, cfg.sketch_cols)}

    def run(layout, flat, g_sum=None):
        st = ClientState(u=flat(u) if scheme.uses_u else {}, v=flat(v) if scheme.uses_v else {},
                         m=flat(m) if scheme.uses_m else {})
        g, new, info = scheme.client_compress(st, flat(grad), flat(gbar)[0], 2, layout=layout,
                                              **kw)
        sst = ServerState(momentum=(sketch_zero if scheme.is_sketch else flat(smom)[0]
                                    if scheme.server_momentum else {}),
                          residual=flat(res)[0] if scheme.downlink_residual else {})
        bc, sst, ainfo = scheme.server_aggregate(sst, g.sum(0) if g_sum is None else g_sum, 3.0,
                                                 layout=layout, lr=0.05)
        return g, new, info, bc, sst, ainfo

    got, want = run(lay, cut_flat), run(big, whole_flat)
    local = run(small, cut_flat)
    key = f"stage/{name}"
    out[f"{key}/cut"] = np.asarray(lay.cut_flags)
    piece = (lambda x: x) if scheme.is_sketch else to_piece
    out[f"{key}/payload"] = np.stack([got[0].numpy(), piece(want[0]).numpy()])
    out[f"{key}/local_payload"] = local[0].numpy()
    for f in ("u", "v", "m"):
        a, b = getattr(got[1], f), getattr(want[1], f)
        if isinstance(a, torch.Tensor):
            out[f"{key}/{f}"] = np.stack([a.numpy(), to_piece(b).numpy()])
    out[f"{key}/upload_nnz"] = np.stack([got[2].upload_nnz.numpy(), want[2].upload_nnz.numpy()])
    out[f"{key}/total"] = np.asarray([got[2].total_params, want[2].total_params,
                                      got[5].total_params, want[5].total_params])
    if scheme.is_sketch:  # the server on the whole run's summed sketch
        got = run(lay, cut_flat, want[0].sum(0))
        out[f"{key}/s_err"] = np.stack([got[4].momentum["s_err"].numpy(),
                                        want[4].momentum["s_err"].numpy()])
    out[f"{key}/bcast"] = np.stack([got[3].numpy(), to_piece(want[3][None])[0].numpy()])
    out[f"{key}/local_bcast"] = local[3].numpy()
    if scheme.downlink_residual:
        out[f"{key}/residual"] = np.stack([got[4].residual.numpy(),
                                           to_piece(want[4].residual[None])[0].numpy()])
    if scheme.server_momentum:
        out[f"{key}/momentum"] = np.stack([got[4].momentum.numpy(),
                                           to_piece(want[4].momentum[None])[0].numpy()])
    out[f"{key}/download_nnz"] = np.asarray([int(got[5].download_nnz),
                                             int(want[5].download_nnz)])
    out[f"{key}/union_nnz"] = np.asarray([int(got[5].union_nnz), int(want[5].union_nnz)])


# STAGES' leaves in three dtypes (a tree of mixed dtypes, ROADMAP item 15):
# the bfloat16 and float32 groups hold cut and whole leaves, the float16
# group one whole leaf (a group none of whose leaves is cut)
MIXED_DTYPES = {"a": torch.bfloat16, "b": torch.float32, "c": torch.float32,
                "d": torch.bfloat16, "e": torch.float16, "f": torch.float32}
# the stages that work across leaves or key their draws by leaf, over it
MIXED_CASES = {
    "global_dgc": dict(scheme="dgc", per_tensor=False),
    "global_dgcwgmf": dict(scheme="dgcwgmf", per_tensor=False),
    "randomk": dict(scheme="randomk"),
    "fetchsgd": dict(scheme="fetchsgd"),
    "probquant": dict(scheme="dgc", wire_stage="probquant"),
    "hadamard": dict(scheme="dgc", rotation_stage="hadamard"),
    "adaptive_global": dict(scheme="adaptive_dgcwgmf", per_tensor=False),
    "dl_global": dict(scheme="dgcwgmf_dl", per_tensor=False),
}


def _tree_np(layout, x):
    """A flat quantity of ``layout`` (one stack per dtype group of a
    ``GroupedLayout``) as one float32 numpy stack in tree order."""
    if not isinstance(x, tuple):
        return x.float().numpy()
    segs = [sub.segments(g) for sub, g in zip(layout.groups, x, strict=True)]
    return torch.cat([segs[g][p].float() for g, p in layout.where], dim=-1).numpy()


def mixed_stage_case(group, name, out):
    """``MIXED_CASES[name]`` through ``client_compress`` and
    ``server_aggregate`` on STAGES' leaves in MIXED_DTYPES: the rank's pieces
    over the model group (each dtype group's layout ``over`` it, the whole
    tree's sizes beside it) and the whole leaves (no group), each output in
    tree order as the rank's pieces. Integer-valued inputs in [-6, 6] under
    GMF (norms exact in any order), normal draws elsewhere; the sketch's
    server also runs on the whole run's summed sketch."""
    from repro_torch.core.state import ServerState
    from repro_torch.utils import tree_map
    from repro_torch.utils.flat import Box

    r = dist.get_rank(group)
    rng = np.random.default_rng(17)
    shapes = {k: (ROWS, *s) for k, (s, _) in STAGES.items()}
    cfg = CompressionConfig(rate=0.1, downlink_rate=0.1, **MIXED_CASES[name])
    scheme = resolve(cfg)
    ints = scheme.fusion.name == "gmf"

    def draw():
        return {k: torch.from_numpy((rng.integers(-6, 7, size=s) if ints else
                                     rng.normal(size=s)).astype(np.float32)).to(MIXED_DTYPES[k])
                for k, s in shapes.items()}

    big = FlatLayout.of({k: torch.zeros(s, dtype=MIXED_DTYPES[k])
                         for k, (s, _) in STAGES.items()})
    small = FlatLayout.of({k: x[0] for k, x in pieces(draw(), r, STAGES).items()})
    places = [(None, [Box(s, tuple(q * (n // WORLD) if j == d else 0 for j, n in enumerate(s)))
                      for _, (s, d) in sorted(STAGES.items())]) for q in range(WORLD)]
    lay = small.over(group, big.sizes, places)
    u, v, m, res, smom, grad, gbar = (draw() for _ in range(7))
    kw = dict(client_ids=torch.tensor([3, 8, 1]))
    if scheme.rate_adaptive:
        kw.update(rates=torch.tensor([0.05, 0.2, 0.5]), wire_levels=torch.tensor([0, 1, 0]))
    whole_flat = lambda t: big.flatten(t)  # noqa: E731
    cut_flat = lambda t: small.flatten(pieces(t, r, STAGES))  # noqa: E731
    to_piece = lambda x: small.flatten(pieces(big.unflatten(x), r, STAGES))  # noqa: E731
    first = lambda x: tree_map(lambda y: y[0], x)  # noqa: E731
    sketch_zero = {"s_mom": torch.zeros(cfg.sketch_rows, cfg.sketch_cols),
                   "s_err": torch.zeros(cfg.sketch_rows, cfg.sketch_cols)}

    def run(layout, flat, g_sum=None):
        st = ClientState(u=flat(u) if scheme.uses_u else {}, v=flat(v) if scheme.uses_v else {},
                         m=flat(m) if scheme.uses_m else {})
        g, new, info = scheme.client_compress(st, flat(grad), first(flat(gbar)), 2,
                                              layout=layout, **kw)
        sst = ServerState(momentum=(sketch_zero if scheme.is_sketch else first(flat(smom))
                                    if scheme.server_momentum else {}),
                          residual=first(flat(res)) if scheme.downlink_residual else {})
        if g_sum is None:
            g_sum = tree_map(lambda x: x.sum(0), g)
        bc, sst, ainfo = scheme.server_aggregate(sst, g_sum, 3.0, layout=layout, lr=0.05)
        return g, new, info, bc, sst, ainfo

    got, want = run(lay, cut_flat), run(big, whole_flat)
    key = f"mixed/{name}"
    out[f"{key}/groups"] = np.asarray([[sub.cut for sub in lay.groups],
                                       [sub.tree_sizes == big.sizes for sub in lay.groups]])
    piece = (lambda x: x) if scheme.is_sketch else to_piece
    out[f"{key}/payload"] = np.stack([_tree_np(lay, got[0]), _tree_np(lay, piece(want[0]))])
    for f in ("u", "v", "m"):
        a, b = getattr(got[1], f), getattr(want[1], f)
        if isinstance(a, tuple):
            out[f"{key}/{f}"] = np.stack([_tree_np(lay, a), _tree_np(lay, to_piece(b))])
    out[f"{key}/upload_nnz"] = np.stack([got[2].upload_nnz.numpy(), want[2].upload_nnz.numpy()])
    if scheme.is_sketch:  # the server on the whole run's summed sketch
        got = run(lay, cut_flat, want[0].sum(0))
        out[f"{key}/s_err"] = np.stack([got[4].momentum["s_err"].numpy(),
                                        want[4].momentum["s_err"].numpy()])
    lift = lambda x: tree_map(lambda y: y[None], x)  # noqa: E731
    out[f"{key}/bcast"] = np.stack([_tree_np(lay, lift(got[3]))[0],
                                    _tree_np(lay, to_piece(lift(want[3])))[0]])
    out[f"{key}/bcast_dtypes"] = np.asarray([str(x.dtype) for x in got[3]] +
                                            [str(x.dtype) for x in want[3]])
    if scheme.downlink_residual:
        out[f"{key}/residual"] = np.stack([_tree_np(lay, lift(got[4].residual))[0],
                                           _tree_np(lay, to_piece(lift(want[4].residual)))[0]])
    out[f"{key}/download_nnz"] = np.asarray([int(got[5].download_nnz),
                                             int(want[5].download_nnz)])
    out[f"{key}/union_nnz"] = np.asarray([int(got[5].union_nnz), int(want[5].union_nnz)])


def mixed_step(mesh, out):
    """One gmf_data step of granite-moe (smoke, bfloat16 beside its float32
    routers: two dtype groups) under global top-k at (1, 2) and whole, both
    fed the same numpy-seeded gradient (the mesh run its pieces of it): the
    whole params after it, and the upload and download counts."""
    import dataclasses

    from repro_torch.configs.base import TrainConfig

    cfg = dataclasses.replace(configs.get_smoke("granite-moe-1b-a400m"), dtype="bfloat16",
                              param_dtype="bfloat16")
    whole = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    sh = shr.named_shardings(mesh, shr.param_specs(whole, fsdp=False, mesh=mesh))
    rng = np.random.default_rng(19)
    grad = tree_unflatten(whole, [torch.from_numpy(rng.normal(size=x.shape).astype(
        np.float32)).to(x.dtype) for x in tree_leaves(whole)])
    tcfg = TrainConfig(learning_rate=0.05, total_steps=4, grad_sync="gmf_data")
    ccfg = CompressionConfig(scheme="dgc", rate=0.1, per_tensor=False)
    batch = {k: torch.from_numpy(v).long() for k, v in batch_of(cfg, 3).items()}
    real = dstep._value_and_grad
    zero = torch.zeros(())
    try:
        for tag, params, m, g in (("tp", shr.local_tree(whole, sh), mesh,
                                   shr.local_tree(grad, sh)), ("one", whole, None, grad)):
            dstep._value_and_grad = lambda f, p, b, own=None, g=g: ((zero, zero), g)
            state = dstep.init_train_state(cfg, tcfg, ccfg, params, m)
            state, met = dstep.make_train_step(cfg, tcfg, ccfg, m)(state, batch)
            final = shr.full_tree(state.params, sh) if m is not None else state.params
            for i, x in enumerate(tree_leaves(final)):
                out[f"mixed_step/{tag}/{i}"] = x.float().numpy()
            out[f"mixed_step/{tag}/counts"] = np.asarray(
                [int(met["upload_nnz"].sum()), int(met["download_nnz"])])
        out["mixed_step/dtypes"] = np.asarray([str(x.dtype) for x in tree_leaves(whole)])
        out["mixed_step/cut"] = np.asarray([a.numel() != b.numel() for a, b in zip(
            tree_leaves(shr.local_tree(whole, sh)), tree_leaves(whole), strict=True)])
    finally:
        dstep._value_and_grad = real


HITTER_KS = (1, 9, 5_000, 60_000)


def cut_hitters(group, out):
    """FetchSGD's heavy hitters over the two ranks on a tie-heavy sketch (8
    columns, values rounded to halves, so most estimates tie and the k-th
    largest magnitude's ties span both ranks and whole leaves): the rank's
    piece of the dense update (``hitters_pieces`` over STAGES' layout with
    boxes) and the whole model's (``heavy_hitters``, ties to the lower
    index) cut to the rank's pieces."""
    from repro_torch.core import sketch
    from repro_torch.utils.flat import Box

    r = dist.get_rank(group)
    big = FlatLayout.of({k: torch.zeros(s) for k, (s, _) in STAGES.items()})
    small = FlatLayout.of({k: torch.zeros([n // WORLD if j == d else n for j, n in enumerate(s)])
                           for k, (s, d) in STAGES.items()})
    # every rank's pieces' boxes, in rank order
    places = [(None, [Box(s, tuple(q * (n // WORLD) if j == d else 0 for j, n in enumerate(s)))
                      for _, (s, d) in sorted(STAGES.items())]) for q in range(WORLD)]
    lay = small.over(group, big.sizes, places)
    rng = np.random.default_rng(13)
    s = torch.from_numpy((np.round(rng.normal(size=(5, 8)) * 2) / 2).astype(np.float32))
    for k in HITTER_KS:
        want = sketch.heavy_hitters(s, big.total, k)[2]
        out[f"hitters/{k}"] = np.stack([
            sketch.hitters_pieces(s, lay, k).numpy(),
            small.flatten(pieces(big.unflatten(want[None]), r, STAGES))[0].numpy()])


def stage_cases(group, out):
    for name in STAGE_CASES:
        stage_case(group, name, out)
    for name in MIXED_CASES:
        mixed_stage_case(group, name, out)
    cut_hitters(group, out)


if __name__ == "__main__":
    rank, init, inputs, dest = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((1, WORLD), ("data", "model"), "cpu")
        res: dict = {}
        select(mesh.get_group("model"), res)
        stage_cases(mesh.get_group("model"), res)
        clipped(mesh, res)
        mixed_step(mesh, res)
        engine(mesh, res)
        families(mesh, dict(np.load(inputs)), res)
        np.savez(dest, **res)
    finally:
        dist.destroy_process_group()


def spawn(workdir, inputs: dict):
    """Start the two ranks on ``inputs`` (written to ``workdir``); returns
    their processes, for ``results``."""
    import subprocess
    from pathlib import Path

    here = Path(__file__).resolve().parent
    workdir = Path(workdir)
    np.savez(workdir / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src"), OMP_NUM_THREADS="1")
    init = f"file://{workdir / 'store'}"
    return [subprocess.Popen([sys.executable, str(here / "torch_tp_ranks.py"), str(r), init,
                              str(workdir / "inputs.npz"), str(workdir / f"rank{r}.npz")],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]


def results(workdir, procs, timeout: float = 300.0):
    """Wait for the ranks ``spawn`` started; returns their results. A rank
    that fails raises with its output."""
    from pathlib import Path

    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("\n".join(f"--- rank {i} (rc {p.returncode}):\n{log[-4000:]}"
                                     for i, (p, log) in enumerate(zip(procs, logs, strict=True))))
    return [dict(np.load(Path(workdir) / f"rank{r}.npz")) for r in range(WORLD)]

"""The cases the four-rank mesh tests run, shared by the port's ranks
(``tests/torch_mesh_ranks.py``) and the JAX package's run of the same
cases on four faked CPU devices (``tests/torch_mesh_jax.py``). Plain data:
this module imports nothing."""

WORLD = 4
STEPS = 2  # steps a train case takes (the second runs the global momentum)
BATCH, SEQ = 8, 16
BATCH_KEYS = ("tokens", "labels", "patch_embeds")  # the VLM's batch adds patch embeddings
LR = 0.05
RATE = 0.1

# name -> (arch's smoke config, its overrides, mesh shape, grad_sync). A mesh
# smaller than the world runs on its first ranks (the others sit out, as
# jax.make_mesh takes the first devices); a model axis of 2 cuts the params
# by the reference's _TP_RULES (yi-34b's smoke cuts wq and wk mid-head;
# granite-moe's experts are cut and its vocabulary of 515 stays whole).
TRAIN = {
    "gmf_data": ("llama3.2-1b", {}, (4, 1), "gmf_data"),
    "dense": ("llama3.2-1b", {}, (4, 1), "dense"),
    "gmf_pod": ("llama3.2-1b", {}, (2, 2, 1), "gmf_pod"),
    "gmf_pod_moe": ("granite-moe-1b-a400m", {"moe_impl": "dense"}, (2, 2, 1), "gmf_pod"),
    "dense_ep": ("granite-moe-1b-a400m", {"moe_impl": "ep"}, (4, 1), "dense"),
    "gmf_data_2x1": ("llama3.2-1b", {}, (2, 1), "gmf_data"),
    "dense_1x1": ("llama3.2-1b", {}, (1, 1), "dense"),
    "tp_gmf_data": ("llama3.2-1b", {}, (2, 2), "gmf_data"),
    "tp_gmf_pod": ("llama3.2-1b", {}, (2, 1, 2), "gmf_pod"),
    "tp_dense_yi": ("yi-34b", {}, (2, 2), "dense"),
    "tp_gmf_data_moe": ("granite-moe-1b-a400m", {"moe_impl": "dense"}, (2, 2), "gmf_data"),
    # FSDP over data (ROADMAP item 11 part C2a), forced at smoke size (FSDP);
    # remat as the published configs set it, so the gathers run inside the
    # layers' checkpoints and again in the backward
    "fsdp_dense_vlm": ("qwen2-vl-72b", {"remat": True}, (2, 2), "dense"),
    "fsdp_gmf_data": ("command-r-plus-104b", {"remat": True}, (2, 2), "gmf_data"),
    # (granite's vocabulary of 515 leaves its embedding cut over data alone:
    # a piece the pod's two model ranks hold alike, counted once)
    "fsdp_gmf_pod_122": ("granite-moe-1b-a400m", {"moe_impl": "dense"}, (1, 2, 2), "gmf_pod"),
    "fsdp_gmf_pod_221": ("llama3.2-1b", {}, (2, 2, 1), "gmf_pod"),
    # FSDP x TP x EP, and the expert-parallel MoE at model 2 without FSDP
    "fsdp_dense_ep": ("kimi-k2-1t-a32b", {"moe_impl": "ep", "remat": True}, (2, 2), "dense"),
    "tp_dense_ep": ("granite-moe-1b-a400m", {"moe_impl": "ep"}, (2, 2), "dense"),
    # the stages that cut or key a leaf by flat coordinate over the model axis
    # (ROADMAP item 11 part C2b; the schemes in SCHEMES), and the int8 wire over
    # gmf_pod's data x model rows under FSDP
    "tp_sampled": ("llama3.2-1b", {}, (2, 2), "gmf_data"),
    "tp_global": ("llama3.2-1b", {}, (2, 2), "gmf_data"),
    "tp_int8": ("llama3.2-1b", {}, (2, 2), "gmf_data"),
    "tp_fetchsgd": ("llama3.2-1b", {}, (2, 2), "gmf_data"),
    "tp_adaptive": ("llama3.2-1b", {}, (2, 2), "gmf_data"),
    "fsdp_gmf_pod_122_int8": ("llama3.2-1b", {}, (1, 2, 2), "gmf_pod"),
}
# each train case's compression config (CompressionConfig keywords, the same
# in both packages): dgcwgmf at RATE unless named here
SCHEMES = {
    "tp_sampled": dict(scheme="dgcwgmf", selector="sampled"),
    "tp_global": dict(scheme="dgc", per_tensor=False),
    "tp_int8": dict(scheme="dgc", wire_stage="int8"),
    "tp_fetchsgd": dict(scheme="fetchsgd"),
    "tp_adaptive": dict(scheme="adaptive_dgcwgmf"),
    "fsdp_gmf_pod_122_int8": dict(scheme="dgcwgmf", wire_stage="int8"),
}


# the mesh the JAX side runs a case at, where it is not the case's own: the
# sampled threshold is one sample point's score, and under JAX's (2, 2)
# program (its gradients summed in another order over the model axis) an
# entry of the whole leaf within that noise of it crosses it at step 0,
# which the second step's gradient then carries everywhere. JAX computes
# the same (unsharded) function at any mesh: at (2, 1) the same two clients.
JAX_SHAPE = {"tp_sampled": (2, 1)}


# boundary flips a shard the comparison allows (FLIPS in the test) where a
# case's own differs: the int8 wire rounds x / scale to the nearest step, and
# an entry within the two sides' gradient noise (~1e-6) of a half step rounds
# the other way, moving by a whole step (scale = block max / 127) in the
# payload, V's residual and the params. Measured 15 (v, (2, 2), both shards)
# and 11 ((1, 2, 2)) on the CPU.
WIRE_FLIPS = {"tp_int8": 32, "fsdp_gmf_pod_122_int8": 32}

# the train cases whose first step's collectives each rank tallies
# (repro_torch.obs.collectives), held against the fake-tensor pass of the
# same configuration (repro_torch.launch.dryrun.trace_train); and those whose
# row layout's owner flags and places, which the specs give on the host, are
# held against what the old collectives over the row's group give
TALLY = ("tp_gmf_data", "tp_dense_yi")
PLACES = ("tp_gmf_data", "tp_sampled", "fsdp_gmf_pod_122")


def scheme_of(name: str) -> dict:
    """The CompressionConfig keywords of train case ``name``."""
    return dict(rate=RATE, **SCHEMES.get(name, {"scheme": "dgcwgmf"}))
ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m", "yi-34b", "qwen2-vl-72b", "command-r-plus-104b",
         "kimi-k2-1t-a32b")
# the cases that run FSDP: the smoke configs fall under needs_fsdp's 40e9
# params, so both sides set dist.step._FSDP_PARAM_THRESHOLD to 0 for them
FSDP = frozenset(k for k in TRAIN if k.startswith("fsdp_"))
# the cases whose health norms (the trainer's --obs block) are held against
# the reference's norms of the whole state (ROADMAP F7)
HEALTH = ("tp_gmf_data", "fsdp_gmf_data", "fsdp_gmf_pod_122", "fsdp_gmf_pod_221")
CLIENT_MESH = 2  # the client mesh of the first ranks

# the expert-parallel MoE at (data 2, model 2): a small MoE config (the
# reference's dist_check one), generous capacity (nothing drops) and a
# tight one (assignments drop)
MOE = dict(name="m", family="moe", num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
           d_ff=48, vocab_size=10, num_experts=4, experts_per_token=2)
MOE_CAPACITY = {"generous": 8.0, "tight": 1.0}
MOE_MESH = (2, 2)
MOE_X = {"a2a": (4, 8, 32), "psum": (4, 1, 32)}  # T divides the model axis, T = 1
# moe_ep inside a forward under tensor parallelism (the tokens replicated over
# the model group): the loss sum(y * MOE_W) + MOE_AUX * aux, its gradients
# against JAX's through the shard_map, at the generous capacity
MOE_AUX = 0.1


def axes_of(shape):
    return ("pod", "data", "model")[-len(shape):]


def members(shape) -> int:
    """The ranks a mesh of ``shape`` holds: the first ones of the world."""
    n = 1
    for s in shape:
        n *= s
    return n


def uneven_labels(labels):
    """-1 on most of the first two rows' labels: the valid counts differ
    across ranks (and across a pod's data ranks)."""
    labels = labels.copy()
    labels[0, :12] = -1
    labels[1, :5] = -1
    return labels

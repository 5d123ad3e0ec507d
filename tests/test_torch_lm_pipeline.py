"""The LM data pipeline and ``LMTask`` of the port against the JAX
package's: ``SyntheticLMStream``'s batches bit for bit (tokens, the audio
``(B, K, T)`` tokens, the VLM's patch embeddings and its ``-1`` label pad),
``LMTask``'s streams (seeds 1000 + i), held-out batch (seed 7) and batch
provider, and its loss and client gradients for each of the ten
architectures at ``smoke()``.

Tolerance: the loss and every gradient leaf within 1e-5 of JAX's, per leaf
relative to its largest magnitude (float32; the frameworks sum matrix
products in other orders). The gradients are taken as the engines take
them, ``torch.func.vmap(torch.func.grad(loss))`` over a client axis.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import torch_train_parity as tr
from repro.data.pipeline import SyntheticLMStream as JStream
from repro.fl import LMTask as JTask
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import SyntheticLMStream as TStream
from repro_torch.fl import LMTask as TTask
from repro_torch.utils import tree_leaves
from repro_torch.utils.convert import from_jax_params

ARCHS = list(tconfigs.ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_lm_stream_is_bitwise_the_reference(arch):
    cfg = tconfigs.get_smoke(arch)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=12, batch_size=3, seed=5,
              num_codebooks=cfg.num_codebooks, num_patches=cfg.num_patches,
              d_model=cfg.d_model)
    js, ts = JStream(**kw), TStream(**kw)
    for _ in range(3):
        jb, tb = next(js), next(ts)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), (arch, k)
    if cfg.family == "audio":
        assert tb["tokens"].shape == (3, cfg.num_codebooks, 12)
    if cfg.family == "vlm":
        assert tb["patch_embeds"].shape == (3, cfg.num_patches, cfg.d_model)
        assert (tb["labels"][:, :cfg.num_patches] == -1).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_lmtask_batches_loss_and_client_gradients_match(arch):
    jcfg, tcfg = tr.configs(arch)
    jp, np_params = tr.jax_params(jcfg, seed=2)
    tp = from_jax_params(np_params, layout="transformer")
    jtask = JTask(jcfg, num_clients=3, batch_size=2, seq_len=12)
    ttask = TTask(tcfg, num_clients=3, batch_size=2, seq_len=12, device="cpu")
    for k, v in jtask.held_out.items():
        assert np.array_equal(ttask.held_out[k].numpy(), np.asarray(v)), k
    ids = np.array([0, 2])
    jb = jtask.batch_provider(0, ids, None)
    tb = ttask.batch_provider(0, ids, None)
    for k in jb:
        assert np.array_equal(tb[k].numpy(), np.asarray(jb[k])), k

    jl = float(jax.jit(jtask.loss_fn)(jp, jtask.held_out))
    assert abs(ttask.held_out_loss(tp) - jl) <= tr.REL * abs(jl)
    assert abs(ttask.eval_fn(tp) - float(jtask.eval_fn(jp))) <= 1e-6

    jg = jax.jit(jax.vmap(jax.grad(jtask.loss_fn), in_axes=(None, 0)))(jp, jb)
    # on torch's own pool: mamba2's SSD gradient sums float32 over the pool's
    # threads, and at one thread it lies 1.9e-5 from JAX's (within 1e-5 here)
    with torch_threads.default_pool():
        tg = torch.func.vmap(torch.func.grad(ttask.loss_fn), in_dims=(None, 0))(tp, tb)
    errs = tr.leaf_errors(tg, jg)
    assert max(errs) <= tr.REL, (arch, max(errs))
    assert len(tree_leaves(tg)) == len(jax.tree_util.tree_leaves(jg))


def test_lmtask_loss_wraps_the_vlm_label_pad_as_the_reference_does():
    """The VLM's -1 labels gather vocab id V - 1 in both packages (ROADMAP
    R12): the loss counts the patch positions in its mean."""
    _, tcfg = tr.configs("qwen2-vl-72b")
    ttask = TTask(tcfg, num_clients=1, batch_size=2, seq_len=8, device="cpu")
    logits = torch.randn(2, tcfg.num_patches + 8, tcfg.vocab_size)
    labels = ttask.held_out["labels"]
    assert (labels == -1).any()
    logp = torch.log_softmax(logits, -1)
    want = jnp.take_along_axis(jnp.asarray(logp.numpy()), jnp.asarray(labels.numpy())[..., None],
                               axis=-1)
    got = torch.gather(logp, -1, torch.remainder(labels, tcfg.vocab_size)[..., None])
    assert np.array_equal(got.numpy(), np.asarray(want))

"""Skip-gram word embeddings with a sparse gradient exchange (reference
examples/tensorflow_word2vec.py), the port of ``examples/jax_word2vec.py``.

Each step's embedding gradient touches a handful of rows, not the dense
``[vocab, dim]`` table, and Horovod's sparse path reduces it as an
allgather of the values and of the indices. Here the gradients are taken
with respect to the *gathered rows* (``torch.autograd.grad``), so the
wire carries ``O(batch x dim)`` through ``hvd.allreduce_sparse``, and
duplicate rows accumulate (``dense_rows=``), under ``hvd.spmd_fn``.

The corpus is the JAX example's synthetic one (:func:`make_batches`, the
same numpy draws): a vocabulary split into topics, pairs drawn within a
topic, so the learned embeddings must cluster by topic, which the
example checks with an intra- against inter-topic cosine margin.

Run:  python -m horovod_tpu_torch.examples.word2vec [--smoke]
      (``--device cpu`` on the CPU; the card by default)
"""

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.distributed as hvd
from horovod_tpu_torch import examples
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.parallel.spmd import P


def make_batches(vocab, topics, batch, steps, negatives, seed=0):
    """Skip-gram (center, context, negatives) triples: center and context
    come from the same topic (co-occurrence), negatives from the unigram
    distribution over the whole vocabulary."""
    rng = np.random.RandomState(seed)
    words_per_topic = vocab // topics
    topic_of = np.arange(vocab) // words_per_topic
    centers = rng.randint(0, vocab, size=(steps, batch))
    # Context: another word from the center's topic.
    offset = rng.randint(1, words_per_topic, size=(steps, batch))
    contexts = (centers // words_per_topic) * words_per_topic + (
        centers % words_per_topic + offset) % words_per_topic
    negs = rng.randint(0, vocab, size=(steps, batch, negatives))
    return centers.astype(np.int32), contexts.astype(np.int32), \
        negs.astype(np.int32), topic_of


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--vocab", type=int, default=2048)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--topics", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=64,
                        help="per-card skip-gram pairs per step")
    parser.add_argument("--negatives", type=int, default=5)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--lr", type=float, default=0.5)
    parser.add_argument("--smoke", action="store_true",
                        help="small sizes + clustering assertion")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.smoke:
        args.vocab, args.dim, args.topics = 96, 16, 8
        args.steps, args.batch_size, args.lr = 400, 32, 5.0
    if args.vocab % args.topics != 0 or args.vocab // args.topics < 2:
        parser.error(
            f"--vocab ({args.vocab}) must be a multiple of --topics "
            f"({args.topics}) with at least 2 words per topic")

    examples.init(args.device)
    n, r, dev = hvd.size(), hvd.rank(), basics.device()
    vocab, dim, lr, B = args.vocab, args.dim, args.lr, args.batch_size

    rng = np.random.RandomState(1)
    params = {
        "in": torch.tensor(rng.uniform(-0.5 / dim, 0.5 / dim, (vocab, dim)),
                           dtype=torch.float32, device=dev),
        "out": torch.zeros((vocab, dim), dtype=torch.float32, device=dev),
    }
    # The same initial table everywhere: the root broadcasts (reference
    # broadcast_global_variables).
    hvd.broadcast_parameters(params, root_rank=0)

    def step(params, batch):
        emb_in, emb_out = params["in"], params["out"]
        c, o, neg = batch["center"], batch["context"], batch["negatives"]
        # The loss of the GATHERED rows only: autograd gives per-row
        # gradients (the IndexedSlices analogue), not a dense scatter.
        rows = [t.detach().requires_grad_()
                for t in (emb_in[c], emb_out[o], emb_out[neg])]
        e_rows, u_pos, u_neg = rows
        pos = (e_rows * u_pos).sum(-1)
        negd = torch.einsum("bd,bkd->bk", e_rows, u_neg)
        loss = -(F.logsigmoid(pos) + F.logsigmoid(-negd).sum(-1)).mean()
        g_e, g_pos, g_neg = torch.autograd.grad(loss, rows)
        # The sparse cross-rank exchange: O(batch x dim) wire bytes.
        d_in = hvd.allreduce_sparse(c, g_e, dense_rows=vocab, average=True)
        idx_out = torch.cat([o, neg.reshape(-1)])
        val_out = torch.cat([g_pos, g_neg.reshape(-1, dim)])
        d_out = hvd.allreduce_sparse(idx_out, val_out, dense_rows=vocab,
                                     average=True)
        new = {"in": emb_in - lr * d_in, "out": emb_out - lr * d_out}
        return new, hvd.allreduce(loss.detach(), average=True)

    run_step = hvd.spmd_fn(step, in_specs=(P(), P("hvd")),
                           out_specs=(P(), P()))

    centers, contexts, negs, topic_of = make_batches(
        vocab, args.topics, B * n, args.steps, args.negatives)
    rows = slice(r * B, (r + 1) * B)
    log = print if r == 0 else (lambda *a, **k: None)
    first_loss = loss = None
    for s in range(args.steps):
        batch = {k: torch.tensor(v[s, rows], dtype=torch.long, device=dev)
                 for k, v in (("center", centers), ("context", contexts),
                              ("negatives", negs))}
        params, loss = run_step(params, batch)
        if s == 0:
            first_loss = float(loss)
        if s % max(1, args.steps // 10) == 0:
            log(f"step {s:5d}  loss {float(loss):.4f}", file=sys.stderr)
    last_loss = float(loss)
    log(f"loss: {first_loss:.4f} -> {last_loss:.4f}", file=sys.stderr)

    # The embeddings must cluster by topic: the mean cosine similarity
    # within a topic clearly beats the cross-topic mean.
    emb = params["in"].cpu().numpy()
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)
    cos = emb @ emb.T
    same = topic_of[:, None] == topic_of[None, :]
    np.fill_diagonal(same, False)
    np.fill_diagonal(cos, 0.0)
    intra = cos[same].mean()
    inter = cos[~same & ~np.eye(len(cos), dtype=bool)].mean()
    log(f"cosine: intra-topic {intra:.3f}  inter-topic {inter:.3f}",
        file=sys.stderr)

    if r == 0:
        assert last_loss < first_loss * 0.7, (first_loss, last_loss)
        if args.smoke:
            assert intra > inter + 0.2, (intra, inter)
        print(f"{last_loss:.6f}")
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Train the composed dp x sp x tp GPT-style LM
(:mod:`horovod_tpu_torch.models.parallel_lm`), the port of
``examples/jax_gpt_parallel.py``.

Every rank holds its shard of the dense parameter dict
(``shard_lm_params`` along ``lm_param_specs``: attention heads and MLP
features over tp), the sequence axis shards over sp with exact ring
attention, the batch over dp; gradients reduce through ``reduce_grads``
(sum over sp, mean over dp) and SGD updates each shard in place. The
mesh comes from the world size as the JAX example derives it from the
device count: sp 2 where the size is even, tp 2 where what is left is
even, dp the rest (4 ranks: dp=1 x sp=2 x tp=2).

Run:  hvdrun-torch -np 4 python -m horovod_tpu_torch.examples.gpt_parallel
      [--smoke] (``--device cpu`` on the CPU; the card by default)
"""

import argparse
import sys

import numpy as np
import torch

import horovod_tpu_torch.distributed as hvd
from horovod_tpu_torch import examples
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import parallel_lm as plm
from horovod_tpu_torch.parallel import LogicalMesh, bind


def successor_corpus(vocab: int, batch: int, seq_len: int) -> tuple:
    """The JAX example's learnable corpus: a fixed random bigram
    successor table, and ``batch`` sequences that follow it from start
    tokens ``0, 1, 2, ...``. Returns ``(succ, seq)``."""
    succ = np.random.RandomState(1).randint(0, vocab, vocab)
    seq = np.zeros((batch, seq_len), np.int32)
    seq[:, 0] = np.arange(batch) % vocab
    for t in range(1, seq_len):
        seq[:, t] = succ[seq[:, t - 1]]
    return succ, seq


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--vocab", type=int, default=256)
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--head-dim", type=int, default=32)
    parser.add_argument("--ffn", type=int, default=1024)
    parser.add_argument("--seq-len", type=int, default=256,
                        help="global sequence length (shards over sp)")
    parser.add_argument("--batch", type=int, default=8,
                        help="global batch (shards over dp)")
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--lr", type=float, default=0.3)
    parser.add_argument("--fused-ce", action="store_true",
                        help="train through the chunked vocab-parallel "
                             "loss (ops/xent.py): the head shards "
                             "[E, V/tp] and the [B, L, vocab] logits "
                             "tensor never materializes")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.smoke:
        args.vocab, args.layers, args.heads = 64, 2, 4
        args.head_dim, args.ffn = 8, 64
        args.seq_len, args.batch, args.steps = 64, 4, 120

    examples.init(args.device)
    n, rank, dev = hvd.size(), hvd.rank(), basics.device()
    sp = 2 if n % 2 == 0 else 1
    tp = 2 if (n // sp) % 2 == 0 else 1
    dp = n // (sp * tp)
    log = print if rank == 0 else (lambda *a, **k: None)
    log(f"mesh dp={dp} x sp={sp} x tp={tp} over {n} ranks ({dev.type})",
        file=sys.stderr)
    if args.heads % tp or args.seq_len % sp or args.batch % dp:
        parser.error("heads must divide by tp, seq-len by sp and batch "
                     "by dp")
    vp = args.fused_ce and tp > 1
    if vp and args.vocab % tp:
        parser.error("--fused-ce vocab-parallel head needs vocab % tp == 0")

    mesh = LogicalMesh.from_config(f"dp={dp},sp={sp},tp={tp}")
    dp_i, sp_i, tp_i = (int(x) for x in np.argwhere(mesh.ranks == rank)[0])
    dense = plm.init_lm_params(0, args.vocab, args.seq_len, args.layers,
                               args.heads, args.head_dim, args.ffn,
                               device="cpu")
    specs = plm.lm_param_specs(args.layers, "tp" if tp > 1 else None,
                               vocab_parallel=vp)
    params = plm.params_to(plm.shard_lm_params(dense, specs, tp, tp_i),
                           dev)
    leaves = [t.requires_grad_() for t in _leaves(params)]

    succ, seq = successor_corpus(args.vocab, args.batch, args.seq_len)
    b, l = args.batch // dp, args.seq_len // sp
    tokens = torch.tensor(seq[dp_i * b:(dp_i + 1) * b,
                              sp_i * l:(sp_i + 1) * l],
                          dtype=torch.long, device=dev)
    sp_ax = "sp" if sp > 1 else None
    tp_ax = "tp" if tp > 1 else None
    dp_ax = "dp" if dp > 1 else None

    first = last = None
    with bind(mesh):
        for s in range(args.steps):
            if args.fused_ce:
                h = plm.lm_apply(params, tokens, sp=sp_ax, tp=tp_ax,
                                 return_hidden=True)
                loss = plm.next_token_nll_fused(
                    params, h, tokens, sp=sp_ax, tp=tp_ax,
                    vocab_parallel=vp, t_chunk=64)
            else:
                loss = plm.next_token_nll(
                    plm.lm_apply(params, tokens, sp=sp_ax, tp=tp_ax),
                    tokens, sp=sp_ax)
            grads = torch.autograd.grad(loss, leaves)
            g = plm.reduce_grads(_rebuild(params, iter(grads)), dp=dp_ax,
                                 sp=sp_ax)
            with torch.no_grad():
                for p, gi in zip(leaves, _leaves(g)):
                    p.sub_(args.lr * gi)
            value = loss.detach()
            if dp_ax:
                value = hvd.allreduce(value, average=True, name="gpt.loss")
            if s == 0:
                first = float(value)
            if s % max(1, args.steps // 10) == 0:
                log(f"step {s:4d}  nll {float(value):.4f}", file=sys.stderr)
        last = float(value)
        log(f"nll: {first:.4f} -> {last:.4f}", file=sys.stderr)
        assert last < first * 0.5, (first, last)

        # The trained model must have learnt the bigram table: greedy
        # decoding from short prompts emits each token's successor chain
        # (every rank decodes with its tp shard).
        prompts = seq[:4, :2]
        with torch.no_grad():
            gen = plm.lm_decode(params, prompts,
                                12, device=dev, tp=tp_ax).cpu().numpy()
    want = np.zeros_like(gen)
    prev = prompts[:, -1]
    for t in range(gen.shape[1]):
        prev = succ[prev]
        want[:, t] = prev
    acc = float((gen == want).mean())
    log(f"decode successor accuracy: {acc:.3f}", file=sys.stderr)
    assert acc > 0.9, acc
    log(f"{last:.6f}")
    hvd.shutdown()
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


if __name__ == "__main__":
    sys.exit(main())

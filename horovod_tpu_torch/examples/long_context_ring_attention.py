"""Long-context training with sequence parallelism, the port of
``examples/long_context_ring_attention.py``.

Trains the Transformer LM with its sequence dimension sharded over every
rank: ring attention passes K/V blocks around the ranks while each rank
attends its own queries, so the context grows with the rank count at a
fixed memory a card. The first step is checked against dense attention
on one card (exact, not an approximation) and against Ulysses
all-to-all attention, which runs the flash kernels K1-K3 on the card:
the logits of both and the gradients of the Ulysses model.

Run:  hvdrun-torch -np 2 python -m \\
          horovod_tpu_torch.examples.long_context_ring_attention --smoke
      (``--device cpu`` on the CPU; the card by default)
"""

import argparse
import functools
import json
import sys

import numpy as np
import torch

import horovod_tpu_torch.distributed as hvd
from horovod_tpu_torch import examples
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.train import create_train_state
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.ops import attention as fa
from horovod_tpu_torch.parallel import (LogicalMesh, bind, ring_attention,
                                        ulysses_attention)


def _local_nll(model, tokens, offset):
    """The next-token loss within this rank's shard (the boundary
    token's target lives on the next rank; skipped, as in the JAX
    example)."""
    logits = model(tokens, pos_offset=offset)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:, None]).mean()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seq-len", type=int, default=8192,
                        help="global sequence length")
    parser.add_argument("--vocab", type=int, default=1024)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--dim", type=int, default=256)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.smoke:
        args.seq_len, args.dim, args.heads, args.steps = 256, 64, 4, 3

    examples.init(args.device)
    n, r, dev = hvd.size(), hvd.rank(), basics.device()
    log = print if r == 0 else (lambda *a, **k: None)
    L, L_local = args.seq_len, args.seq_len // n
    log(f"{n} ranks, global context {L}, {L_local} tokens/rank")

    def build(attn_fn):
        return TransformerLM(
            vocab_size=args.vocab, num_layers=args.layers,
            num_heads=args.heads, embed_dim=args.dim, max_len=L,
            dtype=torch.float32, attn_fn=attn_fn, seed=0, device=dev)

    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, args.vocab, (1, L)), device=dev)
    local = tokens[:, r * L_local:(r + 1) * L_local]
    offset = r * L_local
    with bind(LogicalMesh.from_config(f"sp={n}")):
        model = build(functools.partial(ring_attention, axis="sp",
                                        causal=True))
        if args.smoke:
            # Exactness: ring == dense == Ulysses on the same weights.
            dense = build(None)
            uly = build(functools.partial(ulysses_attention, axis="sp",
                                          causal=True, use_flash=True))
            for m in (dense, uly):
                m.load_state_dict(model.state_dict())
            with torch.no_grad():
                want = dense(tokens)[:, offset:offset + L_local]
                ring = model(local, pos_offset=offset)
                err = float((want - ring).abs().max())
                log(f"ring vs dense max |err| = {err:.2e}")
                assert err < 1e-3, err
            ring_g = torch.autograd.grad(
                _local_nll(model, local, offset), list(model.parameters()))
            # The Ulysses model's kernel launches, counted from here: K1
            # twice a layer (the loss, then the logits), K2 and K3 once a
            # layer on the card; none on the CPU.
            kernels = (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
            for k in kernels:
                k.launches = 0
            uly_loss = _local_nll(uly, local, offset)
            uly_g = torch.autograd.grad(uly_loss, list(uly.parameters()))
            with torch.no_grad():
                err = float((uly(local, pos_offset=offset) - ring)
                            .abs().max())
            launches = {k.__name__: k.launches for k in kernels}
            gerr = max(float((a - b).abs().max())
                       for a, b in zip(ring_g, uly_g))
            log(f"ulysses vs ring max |err| = {err:.2e}, "
                f"gradients {gerr:.2e}")
            log(f"ulysses kernel launches {json.dumps(launches)}")
            assert err < 1e-3 and gerr < 1e-3, (err, gerr)
            del dense, uly
        # Parameters replicated over sp: their gradients are averaged.
        opt = create_train_state(
            model, torch.optim.Adam(model.parameters(), lr=1e-3),
            device=dev)
        losses = []
        for i in range(args.steps):
            opt.zero_grad()
            loss = _local_nll(model, local, offset)
            loss.backward()
            opt.step()
            losses.append(float(hvd.allreduce(loss.detach(), average=True,
                                              name="sp.loss")))
            log(f"step {i}: loss {losses[-1]:.4f}")
    assert losses[-1] < losses[0], losses
    log("sequence-parallel training OK")
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Records, inside a `with recording()` block, every flash-attention
forward and backward launch of the port with its shapes, dtype,
causality, q_start and valid key counts, so that a reader can compute
each call's least time (benchmark/reference/bounds.py). The port's
operator looks up its forward (`_forward`) and its autograd formula its
backward kernel entry (`flash_attention_bwd`) in the module's globals at
each call, so wrapping the two names sees every launch, a rematerialised
forward's too. The valid key counts stay on the device until
`resolve` reads them, after the profiled tail."""

import contextlib


@contextlib.contextmanager
def recording():
    from unast_tpu_torch.ops import attention as A

    calls = {"fwd": [], "bwd": []}
    fwd, bwd = A._forward, A.flash_attention_bwd

    def note(kind, q, k, kv_lens, causal, q_start):
        calls[kind].append((tuple(q.shape), str(q.dtype).split(".")[-1],
                            int(k.shape[1]), kv_lens, bool(causal),
                            int(q_start)))

    def forward(q, k, v, kv_lens, causal, q_start=0):
        note("fwd", q, k, kv_lens, causal, q_start)
        return fwd(q, k, v, kv_lens, causal, q_start)

    def backward(q, k, v, kv_lens, causal, o, lse, do, q_start=0):
        note("bwd", q, k, kv_lens, causal, q_start)
        return bwd(q, k, v, kv_lens, causal, o, lse, do, q_start)

    A._forward, A.flash_attention_bwd = forward, backward
    try:
        yield calls
    finally:
        A._forward, A.flash_attention_bwd = fwd, bwd


def resolve(calls):
    """The recorded calls with their valid key counts read back to the
    host: {kind: [(q shape, dtype, Tk, lens, causal, q_start)]}."""
    return {kind: [(shape, dtype, tk,
                    [tk] * shape[0] if lens is None else lens.cpu().tolist(),
                    causal, q_start)
                   for shape, dtype, tk, lens, causal, q_start in rows]
            for kind, rows in calls.items()}

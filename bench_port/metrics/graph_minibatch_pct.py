"""Share of the fused updates' minibatches that replayed a captured CUDA
graph: ``graph.replay`` counts in the program's ``minibatch`` spans over
those spans (rl/jit_update.py), in %.  100 where every PPO minibatch
replays; 0 where the loop runs eagerly (AWR).  A program without the
graphs (no ``GRAPH_CACHE`` in ``rl/jit_update.py``) reads None."""
from bench_port.metrics import _program as P


def read(trace, run):
    try:
        from gbrl_tpu_torch.rl import jit_update
    except ImportError:
        return None
    if not hasattr(jit_update, "GRAPH_CACHE"):
        return None
    mbs = P.named(P.window(trace), "minibatch")
    if not mbs:
        return None
    replays = sum(r.counts.get("graph.replay", 0) for r in mbs)
    return 100.0 * replays / len(mbs)

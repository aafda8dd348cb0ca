"""Host time of encoding the rollout's categorical observations into the
learner's codes in one training iteration (``vocab.encode`` spans:
rl/ppo.py ``_features`` over common/utils.py ``CategoryVocab.encode``), in
ms, averaged over the iterations.  A program without the span reads
None."""
from bench_port.metrics import _program as P


def read(trace, run):
    recs = P.window(trace)
    its = P.named(recs, "iteration")
    enc = P.named(recs, "vocab.encode")
    if not its or not enc:
        return None
    return P.ms(enc) / len(its)

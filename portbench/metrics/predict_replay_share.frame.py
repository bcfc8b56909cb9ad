"""predict_replay_share.frame: the Predictor's requests over the
program-traced stretch that replayed a captured CUDA graph, as
``predict.replay`` spans per ``predict`` span. A program that replays no
graph gives nothing to read (None)."""

from portbench.harness import program_trace


def read(rec):
    pt = program_trace.stretch(rec)
    spans = (pt or {}).get("spans", ())
    n = sum(s.name == "predict" for s in spans)
    replays = sum(s.name == "predict.replay" for s in spans)
    return replays / n if n and replays else None

"""ms/MB: the entropy-plan stage (``stage_ms["plan"]``: ``ops/huffman.py``,
``ops/banzai_plan.py``; device synchronised before and after) per input
MB, in the part of the traced window with ``EncodeStats(stage_ms={})``."""


def read(run):
    p = run.parts.get("stages")
    if p is None or not p.mb or "plan" not in (p.stats.stage_ms or {}):
        return None
    return p.stats.stage_ms["plan"] / p.mb

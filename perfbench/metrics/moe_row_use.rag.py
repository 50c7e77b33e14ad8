"""The real (token, expert) pairs' share of the rows the expert products ran over the window, in %: top_k x MoE layers x (prompt tokens + live lanes) / the MoE layers' rows (perfbench/programtrace.py's moe_row_use), from the program's counters snapshotted as the window opened and after it closed."""
from perfbench import programtrace


def read(rec):
    c = rec.counters.get("program")
    if not c:
        return None
    return programtrace.quantities(c, [], [], rec.counters["top_k"],
                                   rec.counters["moe_layers"])["moe_row_use"]

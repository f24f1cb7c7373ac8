"""Device ms per query in every other device activity: torch's sorts,
gathers, aranges, elementwise ops, copies and memsets that the
operators launch."""


def read(summary: dict):
    if not summary.get("trace") or summary["library_us"] <= 0:
        return None
    return summary["library_us"] / 1e3 / summary["queries"]

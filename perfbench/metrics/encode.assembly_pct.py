"""The assembly's share of the encode, %: the encoder's StepTimer step
"assembly" (the native assembly of the fetched groups and the framing of
RAW and SILENT blocks) over its total, on requests run after the window
with the timer attached."""


def read(trace):
    total = sum(trace.steps.values())
    if total <= 0 or "assembly" not in trace.steps:
        return None
    return 100.0 * trace.steps["assembly"] / total

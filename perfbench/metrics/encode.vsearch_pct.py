"""The -V search's share of the encode, %: the encoder's StepTimer steps
"partition search (host)" and "span typing (host)" over its total, on
requests run after the window with the timer attached."""


def read(trace):
    total = sum(trace.steps.values())
    search = sum(trace.steps.get(k, 0.0) for k in
                 ("partition search (host)", "span typing (host)"))
    if total <= 0 or search <= 0:
        return None
    return 100.0 * search / total

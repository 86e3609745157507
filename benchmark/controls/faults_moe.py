"""A fault planted in the program's mixture of experts for the readings
and tests that show a run's comparison fails it."""


def top1_only(real):
    """The program's top-P routing with every token taking its top-1
    expert only: the fault a routing decision can have that the scores,
    compared on the program's own routes, hide."""

    def route(x, router, m):
        p, e, taken = real(x, router, m)
        taken = taken.clone()
        taken[:, 1:] = False
        return p, e, taken

    return route

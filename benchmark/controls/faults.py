"""Faults planted in the program for the readings and tests that show a
run's comparison fails them."""


def worst_merges(real):
    """The program's ToMe merge-index function with each round's least
    similar merges taken in place of the most similar: the fault a merge
    decision can have that the features, merged as it decided, hide."""
    import torch

    def worst(metric, r):
        unm, src, dst = real(metric, r)
        order = torch.cat([unm, src], dim=1).flip(1)
        return order[:, r:].flip(1), order[:, :r], dst

    return worst

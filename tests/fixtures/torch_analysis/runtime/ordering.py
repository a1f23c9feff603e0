# Planted REX004 corpus: unordered set iteration feeding placement.
# rex-expect: REX004=2
import torch


def place_blocks(keys, owners):
    pending = set(keys)
    order = [k for k in pending]                     # planted: arbitrary order
    owners.update((k, i) for i, k in enumerate(sorted(pending)))  # sorted: fine
    rows = torch.tensor([c for c in {2, 0, 1}])      # planted: set literal
    ranked = [c for c in sorted({2, 0, 1})]          # sorted: fine
    for k in enumerate(pending):                     # rex: disable=REX004
        pass
    return order, rows, ranked


def drain(rounds: list):
    # a LIST named like the set above must not be tainted cross-scope
    pending = [r for r in rounds]
    for r in pending:                                # list iteration: fine
        yield r

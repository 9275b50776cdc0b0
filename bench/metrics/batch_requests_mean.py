"""Mean requests a dispatched batch, counted by the serving loop."""


def read(run):
    sizes = [len(b.rids) for s in run.sides for b in s.batches]
    return sum(sizes) / len(sizes) if sizes else None

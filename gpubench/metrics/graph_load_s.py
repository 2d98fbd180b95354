"""graph_load_s: seconds of the program's ``ArtifactRegistry.get_or_build``
for the cell's graph: a load from the registry's disk cache, or in a
checkout's first run the preprocessing (the result line's stderr says
which: ``builds`` / ``disk_hits``)."""


def read(record):
    return record["setup"]["graph_load_s"]

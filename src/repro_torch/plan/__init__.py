"""Planning layer: the graph statistics the plan choices are made from.

Only ``cost.GraphStats`` and its two constructors are ported so far (the
serving bucket ladder reads them); the device model, the cost terms and
``autoplan`` follow with the planning slice.
"""

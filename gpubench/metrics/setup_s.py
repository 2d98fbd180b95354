"""setup_s: seconds from the start of the process's script to the start
of the window: imports, the graph read or built, the program's operand
loaded or preprocessed, the kernels built if not yet, inputs drawn and
every shape warmed."""


def read(record):
    return record["setup"]["setup_s"]

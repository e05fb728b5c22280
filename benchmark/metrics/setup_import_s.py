"""Seconds of the program's import in the run's process: the process
record's "import", from the top of ``eks_tpu_torch/__init__.py`` to its
end. Read from the program when the metric is read, so that importing this
file loads no program."""

from program_spans import process_seconds


def read(rec):
    return process_seconds("import")

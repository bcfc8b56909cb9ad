"""setup_s: the process's start to the first timed step or request."""


def read(rec):
    return rec["setup_s"]

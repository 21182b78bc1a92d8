"""Set-up: process start to the window, on the host's clock."""


def read(record):
    return record["setup_s"]

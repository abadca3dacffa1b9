"""The span around the program's key-form build from the seeded key
material, ended by a synchronise, in s."""


def read(run):
    return run["keygen_s"]

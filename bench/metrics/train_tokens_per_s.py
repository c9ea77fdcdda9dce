"""Tokens of the window's steps over the window's seconds (host clock), the
window running from the first timed step's start to the last one's end."""


def read(record):
    w = record["window"]
    return w["tokens"] / w["seconds"] if w["steps"] else None

"""Timesteps per second: the window's steps over its seconds, the window
synchronised at both ends."""


def read(window):
    return window["steps"] / window["seconds"]

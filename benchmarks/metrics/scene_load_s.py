"""Seconds of `load_scene(path, device="cuda")` during set-up, host clock,
the card's context already made and a synchronise after it: parsing the
XML and OBJ files, the tables, and the LBVH built on the card where the
scene has one."""


def read(run):
    return run.scene_load_s

"""Device ms per image of the copies between host and card (the
profiler's memcpy activities from host to device and back, not those
within the card): the serving layer's ``predict`` copies the images in
and the map out."""

PROFILE = True
DIRECTIONS = ("HtoD", "DtoH")


def read(record):
    profile = record.profile
    if profile is None or not profile.images:
        return None
    copies = [finish - begin for begin, finish, name, kind in profile.device
              if kind == "memcpy"
              and any(direction in name for direction in DIRECTIONS)]
    if not copies:
        return None
    return sum(copies) / 1e3 / profile.images

"""upload_mib_per_mp (MiB/MP): the bytes the port's `Upload` spans that
closed in the window copied to the card (their `bytes` attribute: the
size of upload_inputs' one staging buffer), over the megapixels completed
there."""

from portbench.recorder import closed_in, program


def read(record):
    got = program(record)
    if got is None:
        return None
    prog, window = got
    sizes = [s["attrs"]["bytes"] for s in closed_in(prog["spans"], window)
             if s["name"] == "Upload" and "bytes" in s["attrs"]]
    if not sizes:
        return None
    return sum(sizes) / 2**20 / record["mp"]

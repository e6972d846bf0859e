"""upload_ms_per_mp (ms/MP): the summed time of the port's `Upload`
spans that closed in the window, over the megapixels completed there."""

SPANS = ('Upload',)


def read(record):
    if not record["mp"]:
        return None
    total = sum(end - start for name, start, end in record["spans"]
                if name in SPANS)
    if not total:
        return None
    return total * 1e3 / record["mp"]

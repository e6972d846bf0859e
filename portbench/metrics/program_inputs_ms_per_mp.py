"""program_inputs_ms_per_mp (ms/MP): the summed time of the port's `Fused program inputs` and `Stacked program inputs`
spans that closed in the window, over the megapixels completed there."""

SPANS = ('Fused program inputs', 'Stacked program inputs')


def read(record):
    if not record["mp"]:
        return None
    total = sum(end - start for name, start, end in record["spans"]
                if name in SPANS)
    if not total:
        return None
    return total * 1e3 / record["mp"]

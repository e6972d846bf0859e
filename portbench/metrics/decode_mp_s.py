"""decode_mp_s (MP/s): the megapixels of every image whose request
completed inside the window, over the time from the window's opening to
the last of those completions. Failed requests add nothing."""


def read(record):
    t_open, t_close = record["window"]
    if not record["images"] or t_close <= t_open:
        return None
    return record["mp"] / (t_close - t_open)

"""build.bucket_unhidden_share: the share of the card's bucket work that
the streamed build's host waited on, in percent: the host's time blocked
on a bucket's derivation over the card's time on it, summed over the
window's builds (the program's phase_times["bucket_device_wait"] over
["bucket_device_busy"])."""


def read(ctx: dict):
    pairs = [(p["bucket_device_wait"], p["bucket_device_busy"])
             for p in ctx.get("phases", [])
             if "bucket_device_wait" in p and "bucket_device_busy" in p]
    busy = sum(b for _, b in pairs)
    return 100.0 * sum(w for w, _ in pairs) / busy if busy > 0 else None

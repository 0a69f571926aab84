"""frames_per_s: frames completed in the window over the window's seconds,
over all frames: bootstraps and mapping passes included."""


def read(record):
    frames = record.get("frames")
    if not frames:
        return None
    return len(frames) / record["window_s"]

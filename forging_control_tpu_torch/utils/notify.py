"""Run-completion notifications.

Port of ``forging_control_tpu/utils/notify.py``: the equivalent of the
reference's desktop notification on experiment completion (``Generate
Data/Main.py:267-270``, notifypy).  Headless machines have no desktop: the
default sink logs the event through ``utils.logging``; a notifypy sink is
used when the library is importable and a display exists, and a
webhook-file sink appends JSON lines for external watchers.
"""

from __future__ import annotations

import json
import time

from .logging import get_logger


def notify(title: str, message: str, *, events_file: str | None = None,
           logger=None) -> dict:
    """Emit a completion notification through every available sink.

    Returns the event record (useful for tests and callers that relay it).
    """
    event = {"ts": time.time(), "title": title, "message": message}
    log = logger or get_logger()
    log.info("NOTIFY %s: %s", title, message)
    if events_file:
        with open(events_file, "a") as f:
            f.write(json.dumps(event) + "\n")
    try:  # optional desktop sink (reference parity; absent headless)
        from notifypy import Notify  # type: ignore

        n = Notify()
        n.title = title
        n.message = message
        n.send(block=False)
        event["desktop"] = True
    except Exception:
        event["desktop"] = False
    return event

"""Named logging channels (counterpart of singa_tpu/channel.py; the
reference's include/singa/utils/channel.h): each channel writes to stderr
and/or a file under a channel directory. `GetChannel(name).Send(msg)` is
the reference's usage."""

from __future__ import annotations

import os
import sys
import time


class Channel:

    def __init__(self, name: str, dir_path: str = "."):
        self.name = name
        self.dir_path = dir_path
        self.stderr_enabled = True
        self.file_enabled = False
        self._fh = None

    def EnableDestStderr(self, enable: bool):
        self.stderr_enabled = bool(enable)

    def EnableDestFile(self, enable: bool):
        self.file_enabled = bool(enable)
        if enable and self._fh is None:
            os.makedirs(self.dir_path, exist_ok=True)
            self._fh = open(os.path.join(self.dir_path, self.name), "a")
        elif not enable and self._fh is not None:
            self._fh.close()
            self._fh = None

    def Send(self, message: str):
        line = f"[{time.strftime('%H:%M:%S')}] {self.name}: {message}"
        if self.stderr_enabled:
            print(line, file=sys.stderr, flush=True)
        if self.file_enabled and self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()

    __call__ = Send


_channels: dict[str, Channel] = {}
_channel_dir = "."


def InitChannel(dir_path: str = "."):
    global _channel_dir
    _channel_dir = dir_path


def GetChannel(name: str) -> Channel:
    if name not in _channels:
        _channels[name] = Channel(name, _channel_dir)
    return _channels[name]

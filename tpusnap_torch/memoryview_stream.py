"""io stream adapter over a memoryview, so zero-copy buffers can be handed
to readers that want file-like objects without copying.

Counterpart of tpusnap/memoryview_stream.py (copied unchanged).
"""

import io
from typing import Optional


class MemoryviewStream(io.IOBase):
    def __init__(self, mv: memoryview) -> None:
        self._mv = mv.cast("B")
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def read(self, size: int = -1) -> bytes:
        if self.closed:
            raise ValueError("I/O operation on closed stream")
        if size is None or size < 0:
            chunk = self._mv[self._pos :]
            self._pos = len(self._mv)
        else:
            chunk = self._mv[self._pos : self._pos + size]
            self._pos = min(self._pos + size, len(self._mv))
        return bytes(chunk)

    def readinto(self, b) -> int:
        data = self.read(len(b))
        n = len(data)
        b[:n] = data
        return n

    def seek(self, pos: int, whence: int = io.SEEK_SET) -> int:
        if self.closed:
            raise ValueError("I/O operation on closed stream")
        if whence == io.SEEK_SET:
            new_pos = pos
        elif whence == io.SEEK_CUR:
            new_pos = self._pos + pos
        elif whence == io.SEEK_END:
            new_pos = len(self._mv) + pos
        else:
            raise ValueError(f"Invalid whence: {whence}")
        if new_pos < 0:
            raise ValueError(f"Negative seek position {new_pos}")
        self._pos = new_pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def __len__(self) -> int:
        return len(self._mv)

    def getbuffer(self) -> Optional[memoryview]:
        return self._mv

    def getvalue(self) -> bytes:
        """BytesIO-compatible whole-buffer copy (ReadIO.buf consumers may
        hold either type)."""
        return bytes(self._mv)

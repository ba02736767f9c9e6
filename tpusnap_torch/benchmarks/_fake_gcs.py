"""A local fake of the Google Cloud Storage JSON and upload API, for the
gcs_pipeline harness and the cloud plugin's tests: an HTTP server with
injected per-request latency and fault injection (resumable-upload
chunking, short ranges, no-progress replies, transient 500s).

    state = FakeGCS()
    server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(state))

then point the plugin at ``http://127.0.0.1:<port>`` with the
``api_endpoint`` storage option.
"""

import json
import re
import threading
from http.server import BaseHTTPRequestHandler


class FakeGCS:
    """In-memory GCS fake speaking the JSON/upload API subset the plugin
    uses. Fault injection via the ``faults`` list: each entry is a dict
    consumed (in order) by the matching request kind:
      {"kind": "chunk", "action": "http500"}
      {"kind": "chunk", "action": "short", "keep": <bytes_of_this_chunk>}
      {"kind": "chunk", "action": "no_progress"}  # 308 without Range
      {"kind": "download", "action": "http500"}
    """

    def __init__(self):
        self.objects = {}
        self.sessions = {}  # sid -> {"name":, "data": bytearray, "total": int}
        self.faults = []
        self.request_log = []
        # Injected per-request latency (seconds) — simulates cloud RTT;
        # ThreadingHTTPServer handles each request on its own thread, so
        # concurrent plugin requests overlap their sleeps and the
        # benchmarks/gcs_pipeline harness can measure pipeline
        # concurrency as sum(latency)/wall.
        self.latency_s = 0.0
        self._next_sid = 0
        self._lock = threading.Lock()

    def pop_fault(self, kind):
        with self._lock:
            for i, f in enumerate(self.faults):
                if f["kind"] == kind:
                    return self.faults.pop(i)
        return None


def _make_handler(state: FakeGCS):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # silence
            pass

        def _reply(self, code, headers=None, body=b""):
            if state.latency_s:
                import time as _time

                _time.sleep(state.latency_s)
            self.send_response(code)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def _read_body(self):
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def do_POST(self):
            state.request_log.append(("POST", self.path))
            body = self._read_body()
            m = re.match(r"/upload/storage/v1/b/([^/]+)/o\?uploadType=(\w+)&name=(.*)", self.path)
            if not m:
                return self._reply(404)
            from urllib.parse import unquote

            kind, name = m.group(2), unquote(m.group(3))
            if kind == "resumable":
                with state._lock:
                    sid = str(state._next_sid)
                    state._next_sid += 1
                    state.sessions[sid] = {
                        "name": name,
                        "data": bytearray(),
                    }
                host = self.headers["Host"]
                return self._reply(
                    200, {"Location": f"http://{host}/upload-session/{sid}"}
                )
            if kind == "media":
                state.objects[name] = bytes(body)
                return self._reply(200, body=b"{}")
            return self._reply(404)

        def do_PUT(self):
            state.request_log.append(("PUT", self.path, self.headers.get("Content-Range")))
            body = self._read_body()
            m = re.match(r"/upload-session/(\w+)", self.path)
            if not m:
                return self._reply(404)
            sess = state.sessions.get(m.group(1))
            if sess is None:
                return self._reply(404)
            crange = self.headers.get("Content-Range", "")
            probe = re.match(r"bytes \*/(\d+)", crange)
            if probe:
                # Status query: report persisted bytes. Never a fault target
                # (the plugin relies on it to resynchronize).
                persisted = len(sess["data"])
                if persisted and persisted == int(probe.group(1)):
                    state.objects[sess["name"]] = bytes(sess["data"])
                    return self._reply(200, body=b"{}")
                headers = (
                    {"Range": f"bytes=0-{persisted - 1}"} if persisted else {}
                )
                return self._reply(308, headers)
            m2 = re.match(r"bytes (\d+)-(\d+)/(\d+)", crange)
            if not m2:
                return self._reply(400)
            start, end, total = int(m2.group(1)), int(m2.group(2)), int(m2.group(3))
            fault = state.pop_fault("chunk")
            if fault:
                if fault["action"] == "http500":
                    return self._reply(500)
                if fault["action"] == "no_progress":
                    persisted = len(sess["data"])
                    headers = (
                        {"Range": f"bytes=0-{persisted - 1}"} if persisted else {}
                    )
                    # A stale header reporting no NEW progress; with zero
                    # persisted, omit Range entirely (the rawest form).
                    return self._reply(308, headers)
                if fault["action"] == "short":
                    keep = fault["keep"]
                    if start != len(sess["data"]):
                        return self._reply(503)
                    sess["data"].extend(body[:keep])
                    persisted = len(sess["data"])
                    headers = (
                        {"Range": f"bytes=0-{persisted - 1}"} if persisted else {}
                    )
                    return self._reply(308, headers)
            if start != len(sess["data"]):
                # Offset mismatch — the client must resync via a probe.
                return self._reply(503)
            sess["data"].extend(body)
            if end + 1 == total and len(sess["data"]) == total:
                state.objects[sess["name"]] = bytes(sess["data"])
                return self._reply(200, body=b"{}")
            return self._reply(308, {"Range": f"bytes=0-{len(sess['data']) - 1}"})

        def do_GET(self):
            state.request_log.append(("GET", self.path, self.headers.get("Range")))
            from urllib.parse import unquote

            m = re.match(r"/storage/v1/b/([^/]+)/o/([^?]+)(\?alt=media)?$", self.path)
            if not m:
                return self._reply(404)
            name = unquote(m.group(2))
            if name not in state.objects:
                return self._reply(404)
            data = state.objects[name]
            if m.group(3):  # media download
                fault = state.pop_fault("download")
                if fault and fault["action"] == "http500":
                    return self._reply(500)
                rng = self.headers.get("Range")
                if rng:
                    rm = re.match(r"bytes=(\d+)-(\d+)", rng)
                    lo, hi = int(rm.group(1)), int(rm.group(2))
                    return self._reply(206, body=data[lo : hi + 1])
                return self._reply(200, body=data)
            return self._reply(
                200, body=json.dumps({"size": len(data)}).encode()
            )

        def do_DELETE(self):
            from urllib.parse import unquote

            m = re.match(r"/storage/v1/b/([^/]+)/o/([^?]+)$", self.path)
            name = unquote(m.group(2))
            if name in state.objects:
                del state.objects[name]
                return self._reply(204)
            return self._reply(404)

    return Handler

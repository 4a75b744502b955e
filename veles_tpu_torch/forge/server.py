"""Forge server: a model-hub HTTP service storing versioned packages
(port of ``veles_tpu/forge/server.py``).

Reference capability: veles/forge/forge_server.py:80-915 — a tornado
server with package upload (tar.xz + manifest.json), versions, list/
details queries, delete, thumbnails, email registration. Fresh design:
stdlib ThreadingHTTPServer over a plain directory store
``<root>/<name>/<version>.tar.xz`` + ``manifest.json`` per package;
package thumbnails are supported (PNG per package dir); the
reference's email registration becomes TOKEN ISSUANCE (same
email-identity model, the token returned once in the response instead
of via an SMTP confirmation link — a zero-egress redesign).

API (all JSON unless noted):
- ``GET  /service?query=list``                       -> [manifest...]
- ``GET  /service?query=details&name=N``             -> manifest
- ``GET  /service?query=register&email=E``           -> {"token": ...}
- ``GET  /service?query=unregister&email=E`` (token via the
  ``X-Forge-Token`` header; ``&token=T`` query fallback for old
  clients) -> {"ok": true}
- ``GET  /fetch?name=N&version=V``                   -> package bytes
- ``POST /upload?name=N&version=V`` (body: package)  -> {"ok": true}
- ``GET  /thumbnail?name=N``                         -> PNG bytes
- ``POST /thumbnail?name=N`` (body: PNG)             -> {"ok": true}
- ``POST /delete?name=N``                            -> {"ok": true}

A name or version is one normal path component (letters, digits,
``_.+-``, not starting with a dot); anything else answers 400.

Writes (upload/thumbnail/delete) require the shared admin token or a
registered user's issued token on non-loopback binds; registered
uploads record an ``owner``, and only the owner or admin may
overwrite/delete an owned package.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.thread_pool import ManagedThreads

MANIFEST = "manifest.json"

#: Same shape check the reference applied to registration emails.
_EMAIL_RE = re.compile(r"^[^@\s=]+@[^@\s=]+\.[^@\s=]+$")

#: A package or version name: one normal path component. The reference
#: keeps ``os.path.basename`` of the name, which lets ``.`` and ``..``
#: through to ``rmtree`` and to writes outside the store.
_NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.+-]*$")


class BadName(ValueError):
    """A package or version name that is not one normal component."""


def _component(kind: str, value: str) -> str:
    if not _NAME_RE.match(value or "") or value == _Store.USERS:
        raise BadName("bad %s %r" % (kind, value))
    return value


class _Store:
    """Directory-backed package store; thread-safe."""

    def __init__(self, root: str) -> None:
        # every read and write of the directory tree happens under
        # _lock (the files are the guarded state)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _dir(self, name: str) -> str:
        return os.path.join(self.root, _component("name", name))

    def _package(self, name: str, version: str) -> str:
        return os.path.join(self._dir(name), "%s.tar.xz" %
                            _component("version", version))

    def list(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for name in sorted(os.listdir(self.root)):
                mpath = os.path.join(self.root, name, MANIFEST)
                if os.path.isfile(mpath):
                    with open(mpath) as fin:
                        out.append(json.load(fin))
            return out

    def details(self, name: str) -> Optional[Dict[str, Any]]:
        mpath = os.path.join(self._dir(name), MANIFEST)
        with self._lock:
            if not os.path.isfile(mpath):
                return None
            with open(mpath) as fin:
                return json.load(fin)

    def upload(self, name: str, version: str, blob: bytes,
               metadata: Optional[Dict[str, Any]] = None) -> None:
        d = self._dir(name)
        path = self._package(name, version)
        with self._lock:
            os.makedirs(d, exist_ok=True)
            with open(path, "wb") as f:
                f.write(blob)
            manifest = {"name": name, "version": version,
                        "versions": []}
            mpath = os.path.join(d, MANIFEST)
            if os.path.isfile(mpath):
                with open(mpath) as fin:
                    manifest = json.load(fin)
            manifest["version"] = version  # latest
            if version not in manifest.setdefault("versions", []):
                manifest["versions"].append(version)
            if metadata:
                manifest.update(metadata)
            with open(mpath, "w") as fout:
                json.dump(manifest, fout, indent=2)

    def put_thumbnail(self, name: str, blob: bytes) -> bool:
        d = self._dir(name)
        with self._lock:
            if not os.path.isdir(d):
                return False
            with open(os.path.join(d, "thumbnail.png"), "wb") as f:
                f.write(blob)
            return True

    def thumbnail(self, name: str) -> Optional[bytes]:
        path = os.path.join(self._dir(name), "thumbnail.png")
        with self._lock:
            if not os.path.isfile(path):
                return None
            with open(path, "rb") as fin:
                return fin.read()

    def fetch(self, name: str, version: Optional[str]) -> Optional[bytes]:
        with self._lock:
            manifest_path = os.path.join(self._dir(name), MANIFEST)
            if version is None:
                if not os.path.isfile(manifest_path):
                    return None
                with open(manifest_path) as fin:
                    version = json.load(fin)["version"]
            path = self._package(name, version)
            if not os.path.isfile(path):
                return None
            with open(path, "rb") as fin:
                return fin.read()

    def delete(self, name: str) -> bool:
        with self._lock:
            d = self._dir(name)
            if not os.path.isdir(d):
                return False
            shutil.rmtree(d)
            return True

    # -- user registration (token issuance) ---------------------------------
    # Reference: forge_server.py:80-915 registered users by emailing a
    # confirmation link carrying a generated token. Redesign for a
    # zero-egress deployment: the same identity model (email -> write
    # token, tokens never stored in the clear) with the token returned
    # ONCE in the registration response instead of via SMTP.
    USERS = "users.json"

    def _users_path(self) -> str:
        return os.path.join(self.root, self.USERS)

    def _load_users(self) -> Dict[str, Any]:
        path = self._users_path()
        if os.path.isfile(path):
            with open(path) as fin:
                return json.load(fin)
        return {}

    def _save_users(self, users: Dict[str, Any]) -> None:
        with open(self._users_path(), "w") as fout:
            json.dump(users, fout, indent=2)

    def register(self, email: str) -> Optional[str]:
        """Issue a write token for ``email``; None if registered."""
        import hashlib
        import secrets
        import time
        with self._lock:
            users = self._load_users()
            if email in users:
                return None
            token = secrets.token_hex(16)
            users[email] = {
                "token_sha256": hashlib.sha256(
                    token.encode()).hexdigest(),
                "registered": time.time()}
            self._save_users(users)
            return token

    def unregister(self, email: str, token: str) -> bool:
        import hashlib
        import hmac
        with self._lock:
            users = self._load_users()
            doc = users.get(email)
            if doc is None:
                return False
            digest = hashlib.sha256(token.encode()).hexdigest()
            if not hmac.compare_digest(digest, doc["token_sha256"]):
                return False
            del users[email]
            self._save_users(users)
            return True

    def user_for_token(self, token: str) -> Optional[str]:
        import hashlib
        import hmac
        digest = hashlib.sha256(token.encode()).hexdigest()
        with self._lock:
            for email, doc in self._load_users().items():
                if hmac.compare_digest(digest, doc["token_sha256"]):
                    return email
        return None


class ForgeServer(Logger):
    """Serves a package store over HTTP (daemon thread)."""

    #: Upload size cap (bytes) — packages are model archives, not
    #: datasets; anything larger is a mistake or an attack.
    MAX_UPLOAD = 512 * 1024 * 1024

    def __init__(self, root: str, host: str = "127.0.0.1",
                 port: int = 0, token: Optional[str] = None,
                 open_registration: bool = False,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.store = _Store(root)
        store = self.store
        loopback = host in ("127.0.0.1", "::1", "localhost")
        # Destructive endpoints (upload/delete) need a shared token
        # unless the bind is loopback-only: exposing unauthenticated
        # package overwrite/deletion on 0.0.0.0 is not acceptable.
        # Token ISSUANCE is likewise admin-gated on public binds
        # unless open_registration is explicitly chosen (the
        # reference's open email-confirmed registration model).
        require_token = token is not None or not loopback
        allow_open_register = open_registration or loopback
        max_upload = self.MAX_UPLOAD

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, doc: Any) -> None:
                self._reply(code, json.dumps(doc).encode())

            def _refuse(self, code: int, doc: Any) -> None:
                """Error reply on a request whose body wasn't read:
                drain (bounded) first, else a client mid-upload sees a
                connection reset instead of the HTTP error."""
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    length = 0
                # cap the courtesy drain: an unauthenticated client
                # must not tie up a handler thread streaming GBs
                length = min(length, max_upload)
                drained = 0
                while drained < length:
                    chunk = self.rfile.read(
                        min(1 << 20, length - drained))
                    if not chunk:
                        break
                    drained += len(chunk)
                self._json(code, doc)

            def do_GET(self) -> None:
                try:
                    self._get()
                except BadName as e:
                    self._json(400, {"error": str(e)})

            def do_POST(self) -> None:
                try:
                    self._post()
                except BadName as e:
                    self._json(400, {"error": str(e)})

            def _get(self) -> None:
                url = urlparse(self.path)
                params = {k: v[0] for k, v in
                          parse_qs(url.query).items()}
                if url.path == "/service":
                    query = params.get("query")
                    if query == "list":
                        self._json(200, store.list())
                    elif query == "details":
                        doc = store.details(params.get("name", ""))
                        if doc is None:
                            self._json(404, {"error": "no such package"})
                        else:
                            self._json(200, doc)
                    elif query == "register":
                        import hmac
                        got = self.headers.get("X-Forge-Token") or ""
                        is_admin = (token is not None and got and
                                    hmac.compare_digest(got, token))
                        email = params.get("email", "")
                        if not (allow_open_register or is_admin):
                            self._json(403, {
                                "error": "registration is admin-"
                                         "gated on this bind (send "
                                         "the admin X-Forge-Token, "
                                         "or start the server with "
                                         "open registration)"})
                        elif not _EMAIL_RE.match(email):
                            self._json(400, {"error": "bad email"})
                        else:
                            issued = store.register(email)
                            if issued is None:
                                self._json(409, {
                                    "error": "already registered; "
                                             "unregister first"})
                            else:
                                self._json(200, {"email": email,
                                                 "token": issued})
                    elif query == "unregister":
                        # the user token arrives in the X-Forge-Token
                        # header (query-string tokens leak into proxy
                        # and access logs; kept only as a fallback
                        # for old clients)
                        user_token = (
                            self.headers.get("X-Forge-Token") or
                            params.get("token", ""))
                        ok = store.unregister(
                            params.get("email", ""), user_token)
                        self._json(200 if ok else 403, {"ok": ok})
                    else:
                        self._json(400, {"error": "unknown query"})
                elif url.path == "/fetch":
                    blob = store.fetch(params.get("name", ""),
                                       params.get("version"))
                    if blob is None:
                        self._json(404, {"error": "no such package"})
                    else:
                        self._reply(200, blob, "application/x-xz")
                elif url.path == "/thumbnail":
                    # package preview image (reference: forge served
                    # thumbnails with listings,
                    # veles/forge/forge_server.py)
                    blob = store.thumbnail(params.get("name", ""))
                    if blob is None:
                        self._json(404, {"error": "no thumbnail"})
                    else:
                        self._reply(200, blob, "image/png")
                else:
                    self._json(404, {"error": "not found"})

            def _post(self) -> None:
                url = urlparse(self.path)
                params = {k: v[0] for k, v in
                          parse_qs(url.query).items()}
                # Identify the writer: the shared admin token, or any
                # registered user's issued token (ownership recorded
                # on upload; deletes restricted to owner/admin).
                import hmac
                got = self.headers.get("X-Forge-Token") or ""
                user: Optional[str] = None
                if token is not None and got and \
                        hmac.compare_digest(got, token):
                    user = "admin"
                elif got:
                    user = store.user_for_token(got)
                if require_token and user is None:
                    self._refuse(403,
                                 {"error": "missing or bad token "
                                           "(register via /service"
                                           "?query=register)"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    self._json(400, {"error": "bad Content-Length"})
                    return
                if not 0 <= length <= max_upload:
                    # Don't drain here: the refused body is by
                    # definition oversized; the reset is intentional.
                    self._json(413, {"error": "package too large"})
                    return
                body = self.rfile.read(length)
                # a bad name or version raises BadName in the store
                name = params.get("name", "")
                def owned_by_other(doc) -> bool:
                    """A registered user may only touch packages they
                    own or create; ownerless packages (admin/legacy
                    uploads) are admin-only."""
                    if user in (None, "admin") or doc is None:
                        return False
                    return doc.get("owner") != user

                if url.path == "/upload":
                    if owned_by_other(store.details(name)):
                        self._json(403, {"error": "package owned by "
                                                  "another user"})
                        return
                    version = params.get("version", "1.0")
                    meta = {}
                    if self.headers.get("X-Forge-Metadata"):
                        try:
                            meta = json.loads(
                                self.headers["X-Forge-Metadata"])
                        except ValueError:
                            pass
                    if user not in (None, "admin"):
                        meta["owner"] = user
                    store.upload(name, version, body, meta)
                    self._json(200, {"ok": True})
                elif url.path == "/thumbnail":
                    if owned_by_other(store.details(name)):
                        self._json(403, {"error": "package owned by "
                                                  "another user"})
                        return
                    ok = store.put_thumbnail(name, body)
                    self._json(200 if ok else 404, {"ok": ok})
                elif url.path == "/delete":
                    if owned_by_other(store.details(name)):
                        self._json(403, {"error": "package owned by "
                                                  "another user"})
                        return
                    ok = store.delete(name)
                    self._json(200 if ok else 404, {"ok": ok})
                else:
                    self._json(404, {"error": "not found"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        # Joined in close() via the ManagedThreads discipline — no
        # fire-and-forget daemon listener.
        self._threads = ManagedThreads(name="forge-server")
        self._thread = self._threads.spawn(
            self._httpd.serve_forever, name="listener")
        self.info("forge server on %s (store %s)", self.url, root)

    @property
    def url(self) -> str:
        return "http://%s:%d" % self._httpd.server_address[:2]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._threads.join_all(timeout=5)


def main(argv=None) -> int:
    """Standalone forge daemon (reference: the veles.forge_server
    service): ``python -m veles_tpu_torch.forge.server --root DIR``."""
    import argparse
    import signal
    import threading

    parser = argparse.ArgumentParser(prog="veles_tpu_torch.forge.server")
    parser.add_argument("--root", required=True,
                        help="package store directory")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--token", default=None,
                        help="shared write token (required for "
                             "non-loopback binds)")
    parser.add_argument("--open-registration", action="store_true",
                        help="let anyone self-register a write token "
                             "on non-loopback binds (the reference's "
                             "open registration trust model)")
    args = parser.parse_args(argv)
    server = ForgeServer(args.root, host=args.host, port=args.port,
                         token=args.token,
                         open_registration=args.open_registration)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *a: stop.set())
    stop.wait()
    server.close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())

"""Forge client: fetch/upload/list/details/delete + the CLI (port of
``veles_tpu/forge/client.py``; the wire is the reference's, so either
package's client talks to either package's server).

Reference capability: veles/forge/forge_client.py:101-328 (ops) and
:701-798 (CLI: ``veles forge fetch|upload|list|details|delete``).
Package format: ``tar.xz`` holding ``manifest.json`` (name, version,
workflow/config entry files) plus the model files — compatible in
spirit with the reference's manifest-per-package layout; extraction
goes through the ``data`` tar filter. Write tokens travel in the
``X-Forge-Token`` header, never in a URL.
"""

from __future__ import annotations

import io
import json
import lzma
import os
import tarfile
from typing import Any, Dict, List, Optional
from urllib import request as urlrequest
from urllib.parse import urlencode

MANIFEST = "manifest.json"


def pack_package(directory: str, name: str, version: str = "1.0",
                 workflow: Optional[str] = None,
                 config: Optional[str] = None) -> bytes:
    """Pack a model directory into a tar.xz with a manifest. The tar is
    compressed in slices, one xz stream a slice, on threads (``lzma``
    releases the interpreter lock): a concatenation of xz streams is
    one valid ``.xz`` file, which ``tarfile``'s ``r:xz`` reads as it
    reads one stream. One stream at the reference's preset packs a
    full-width AlexNet package (~250 MB of floats) at a few MB/s."""
    manifest = {"name": name, "version": version}
    if workflow:
        manifest["workflow"] = workflow
    if config:
        manifest["config"] = config
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        mblob = json.dumps(manifest, indent=2).encode()
        info = tarfile.TarInfo(MANIFEST)
        info.size = len(mblob)
        tf.addfile(info, io.BytesIO(mblob))
        for dirpath, dirnames, filenames in os.walk(directory):
            dirnames.sort()
            for fname in sorted(filenames):
                full = os.path.join(dirpath, fname)
                arcname = os.path.relpath(full, directory)
                if arcname == MANIFEST:
                    continue
                tf.add(full, arcname)
    return _xz_streams(buf.getbuffer())


#: the smallest slice one xz stream compresses
_XZ_SLICE = 8 << 20
#: LZMA2 preset of the slices: model weights (floats) compress by ~8% at
#: any preset, and 0 is 2-3x faster than the default 6
XZ_PRESET = 0


def _xz_streams(raw: memoryview) -> bytes:
    """``raw`` as concatenated xz streams, one a slice, compressed on up
    to ``os.cpu_count()`` threads."""
    from concurrent.futures import ThreadPoolExecutor
    threads = os.cpu_count() or 1
    size = max(_XZ_SLICE, -(-len(raw) // threads))
    slices = [raw[i:i + size] for i in range(0, len(raw), size)] or [raw]
    with ThreadPoolExecutor(max_workers=min(threads, len(slices)),
                            thread_name_prefix="forge-xz") as pool:
        return b"".join(pool.map(
            lambda piece: lzma.compress(piece, preset=XZ_PRESET), slices))


def unpack_package(blob: bytes, directory: str) -> Dict[str, Any]:
    """Extract a package through the ``data`` tar filter; returns its
    manifest."""
    os.makedirs(directory, exist_ok=True)
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:xz") as tf:
        from veles_tpu_torch.downloader import _extractall
        _extractall(tf, directory)
    with open(os.path.join(directory, MANIFEST)) as fin:
        return json.load(fin)


class ForgeClient:
    def __init__(self, base_url: str,
                 token: Optional[str] = None) -> None:
        self.base_url = base_url.rstrip("/")
        self.token = token

    def _post(self, req: urlrequest.Request, timeout: int) -> None:
        if self.token:
            req.add_header("X-Forge-Token", self.token)
        try:
            with urlrequest.urlopen(req, timeout=timeout) as resp:
                if resp.status != 200:
                    raise RuntimeError("%s failed: %d" %
                                       (req.full_url, resp.status))
        except (BrokenPipeError, ConnectionResetError) as e:
            # The server hangs up mid-body when it refuses an
            # oversized upload (413 without draining).
            raise RuntimeError(
                "%s: connection closed by server (package too "
                "large?)" % req.full_url) from e

    def _get(self, path: str, token: Optional[str] = None,
             **params) -> bytes:
        url = "%s%s?%s" % (self.base_url, path, urlencode(params))
        req = urlrequest.Request(url)
        token = token if token is not None else self.token
        if token:
            # harmless on read routes; authorizes admin-gated
            # registration on public binds and the unregister check
            req.add_header("X-Forge-Token", token)
        with urlrequest.urlopen(req, timeout=30) as resp:
            return resp.read()

    def list(self) -> List[Dict[str, Any]]:
        return json.loads(self._get("/service", query="list"))

    def details(self, name: str) -> Dict[str, Any]:
        return json.loads(self._get("/service", query="details",
                                    name=name))

    def fetch(self, name: str, directory: str,
              version: Optional[str] = None) -> Dict[str, Any]:
        params = {"name": name}
        if version:
            params["version"] = version
        blob = self._get("/fetch", **params)
        return unpack_package(blob, directory)

    def upload(self, directory: str, name: str,
               version: str = "1.0", **manifest_extra) -> None:
        blob = pack_package(directory, name, version)
        url = "%s/upload?%s" % (self.base_url,
                                urlencode({"name": name,
                                           "version": version}))
        req = urlrequest.Request(url, data=blob, method="POST")
        if manifest_extra:
            req.add_header("X-Forge-Metadata",
                           json.dumps(manifest_extra))
        self._post(req, timeout=60)

    def delete(self, name: str) -> None:
        url = "%s/delete?%s" % (self.base_url, urlencode({"name": name}))
        req = urlrequest.Request(url, data=b"", method="POST")
        self._post(req, timeout=30)

    def register(self, email: str) -> str:
        """Register and return the issued write token (reference's
        email-confirmation flow redesigned as direct token issuance —
        forge_server.py:80-915). On admin-gated binds, construct the
        client with the ADMIN token to issue user tokens. Raises on
        409 (already registered) / 403 (gated)."""
        import urllib.error
        try:
            doc = json.loads(self._get("/service", query="register",
                                       email=email))
        except urllib.error.HTTPError as e:
            raise RuntimeError(
                "registration refused: %s" %
                e.read().decode("utf-8", "replace")) from e
        self.token = doc["token"]
        return self.token

    def unregister(self, email: str, token: str) -> bool:
        """The write token travels in the ``X-Forge-Token`` header
        (never the query string, where proxies and access logs would
        capture it; the server keeps a query fallback for old
        clients)."""
        import urllib.error
        try:
            doc = json.loads(self._get("/service", token=token,
                                       query="unregister", email=email))
        except urllib.error.HTTPError:
            return False
        return bool(doc.get("ok"))

    def upload_thumbnail(self, name: str, png: bytes) -> None:
        """Attach a preview image to an uploaded package (reference:
        forge thumbnails, veles/forge/forge_server.py)."""
        url = "%s/thumbnail?%s" % (self.base_url,
                                   urlencode({"name": name}))
        req = urlrequest.Request(url, data=png, method="POST")
        self._post(req, timeout=30)

    def thumbnail(self, name: str) -> bytes:
        return self._get("/thumbnail", name=name)


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m veles_tpu_torch.forge <cmd> ...`` (reference CLI shape)."""
    import argparse
    parser = argparse.ArgumentParser(prog="veles_tpu_torch.forge")
    parser.add_argument("-s", "--server", required=True,
                        help="forge server base url")
    parser.add_argument("-t", "--token", default=None,
                        help="shared write token (upload/delete)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list")
    p = sub.add_parser("details")
    p.add_argument("name")
    p = sub.add_parser("fetch")
    p.add_argument("name")
    p.add_argument("-d", "--directory", default=".")
    p.add_argument("-v", "--version", default=None)
    p = sub.add_parser("upload")
    p.add_argument("directory")
    p.add_argument("-n", "--name", required=True)
    p.add_argument("-v", "--version", default="1.0")
    p = sub.add_parser("delete")
    p.add_argument("name")
    p = sub.add_parser("register")
    p.add_argument("email")
    p = sub.add_parser("unregister")
    p.add_argument("email")
    args = parser.parse_args(argv)

    client = ForgeClient(args.server, token=args.token)
    if args.cmd == "list":
        print(json.dumps(client.list(), indent=2))
    elif args.cmd == "details":
        print(json.dumps(client.details(args.name), indent=2))
    elif args.cmd == "fetch":
        manifest = client.fetch(args.name, args.directory, args.version)
        print("fetched %s %s -> %s" %
              (manifest["name"], manifest["version"], args.directory))
    elif args.cmd == "upload":
        client.upload(args.directory, args.name, args.version)
        print("uploaded %s %s" % (args.name, args.version))
    elif args.cmd == "delete":
        client.delete(args.name)
        print("deleted %s" % args.name)
    elif args.cmd == "register":
        token = client.register(args.email)
        print("registered %s; write token (save it — shown once): %s"
              % (args.email, token))
    elif args.cmd == "unregister":
        ok = client.unregister(args.email, args.token or "")
        print("unregistered" if ok else "unregister refused")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

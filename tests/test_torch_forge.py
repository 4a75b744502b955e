"""The port's forge (``veles_tpu_torch.forge``) against the JAX
package's: the wire is the reference's, so the port's client drives the
reference's server and the reference's client drives the port's, for
upload, fetch, list, details, delete, thumbnails, token issuance,
ownership and admin gating on a public bind. Write tokens travel in
the ``X-Forge-Token`` header and never in a URL.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import veles_tpu.forge as R_forge
import veles_tpu_torch.forge as P_forge
from veles_tpu_torch.forge import client as P_client

PAIRS = {"port-client/ref-server": (P_forge, R_forge),
         "ref-client/port-server": (R_forge, P_forge),
         "port-client/port-server": (P_forge, P_forge)}


def _model(tmp_path, name="model"):
    d = tmp_path / name
    (d / "sub").mkdir(parents=True)
    (d / "weights.bin").write_bytes(bytes(range(256)) * 4)
    (d / "sub" / "config.py").write_text("root.x = 1\n")
    return d


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_upload_fetch_list_details_delete(pair, tmp_path):
    client_pkg, server_pkg = PAIRS[pair]
    model = _model(tmp_path)
    server = server_pkg.ForgeServer(str(tmp_path / "store"))
    try:
        client = client_pkg.ForgeClient(server.url)
        client.upload(str(model), "pkg", version="1.0")
        client.upload(str(model), "pkg", version="1.1")
        listed = client.list()
        assert [m["name"] for m in listed] == ["pkg"]
        details = client.details("pkg")
        assert details["version"] == "1.1"
        assert details["versions"] == ["1.0", "1.1"]
        manifest = client.fetch("pkg", str(tmp_path / "out"),
                                version="1.0")
        assert manifest["name"] == "pkg" and manifest["version"] == "1.0"
        assert (tmp_path / "out" / "weights.bin").read_bytes() == \
            (model / "weights.bin").read_bytes()
        assert (tmp_path / "out" / "sub" / "config.py").read_text() == \
            "root.x = 1\n"
        client.upload_thumbnail("pkg", b"\x89PNG fake")
        assert client.thumbnail("pkg") == b"\x89PNG fake"
        client.delete("pkg")
        assert client.list() == []
        with pytest.raises(urllib.error.HTTPError) as err:
            client.details("pkg")
        assert err.value.code == 404
    finally:
        server.close()


def test_packages_unpack_in_both_packages(tmp_path):
    """``pack_package`` writes the reference's tar.xz + manifest.json;
    either package unpacks the other's (the port through the ``data``
    extraction filter)."""
    model = _model(tmp_path)
    blobs = {name: mod.pack_package(str(model), "pkg", "2.0",
                                    workflow="wf.py")
             for name, mod in (("ref", R_forge), ("port", P_forge))}
    for unpacker, mod in (("ref", R_forge), ("port", P_forge)):
        for packer, blob in blobs.items():
            out = tmp_path / ("%s-from-%s" % (unpacker, packer))
            manifest = mod.unpack_package(blob, str(out))
            assert manifest == {"name": "pkg", "version": "2.0",
                                "workflow": "wf.py"}
            assert (out / "weights.bin").read_bytes() == \
                (model / "weights.bin").read_bytes()


def test_sliced_xz_streams_unpack_in_both_packages(tmp_path,
                                                   monkeypatch):
    """The port packs a large tar as several xz streams compressed on
    threads; the concatenation is one valid .xz that the reference's
    ``unpack_package`` (and the port's) reads whole."""
    import lzma
    monkeypatch.setattr(P_client, "_XZ_SLICE", 1 << 12)
    model = _model(tmp_path)
    (model / "big.bin").write_bytes(np.random.default_rng(0).bytes(1 << 16))
    blob = P_forge.pack_package(str(model), "pkg", "1.0")
    streams = blob.count(b"\xfd7zXZ\x00")
    assert streams > 1
    assert len(lzma.decompress(blob)) > 1 << 16
    for name, mod in (("ref", R_forge), ("port", P_forge)):
        out = tmp_path / name
        assert mod.unpack_package(blob, str(out))["name"] == "pkg"
        assert (out / "big.bin").read_bytes() == \
            (model / "big.bin").read_bytes()


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_tokens_and_ownership(pair, tmp_path):
    """Registration issues tokens; a registered upload records its
    owner; another user can neither overwrite nor delete it; the admin
    can; unregister revokes."""
    client_pkg, server_pkg = PAIRS[pair]
    model = _model(tmp_path)
    server = server_pkg.ForgeServer(str(tmp_path / "store"),
                                    token="admin-secret")
    try:
        alice = client_pkg.ForgeClient(server.url)
        with pytest.raises(urllib.error.HTTPError):
            alice.upload(str(model), "pkg")  # unregistered: 403
        token_a = alice.register("alice@example.com")
        assert token_a
        with pytest.raises(RuntimeError, match="registration refused"):
            client_pkg.ForgeClient(server.url).register(
                "alice@example.com")
        with pytest.raises(RuntimeError):
            client_pkg.ForgeClient(server.url).register("not-an-email")
        alice.upload(str(model), "pkg")
        assert alice.details("pkg")["owner"] == "alice@example.com"
        bob = client_pkg.ForgeClient(server.url)
        bob.register("bob@example.com")
        with pytest.raises(urllib.error.HTTPError) as err:
            bob.delete("pkg")
        assert err.value.code == 403
        with pytest.raises(urllib.error.HTTPError):
            bob.upload(str(model), "pkg")
        client_pkg.ForgeClient(server.url, token="admin-secret").delete(
            "pkg")
        assert alice.unregister("alice@example.com", token_a)
        with pytest.raises(urllib.error.HTTPError):
            alice.upload(str(model), "pkg2")
        assert not alice.unregister("bob@example.com", "wrong")
    finally:
        server.close()


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_registration_admin_gated_on_public_bind(pair, tmp_path):
    client_pkg, server_pkg = PAIRS[pair]
    server = server_pkg.ForgeServer(str(tmp_path / "store"),
                                    host="0.0.0.0", token="adm")
    try:
        with pytest.raises(RuntimeError, match="admin-gated"):
            client_pkg.ForgeClient(server.url).register("x@example.com")
        issued = client_pkg.ForgeClient(server.url, token="adm").register(
            "x@example.com")
        assert issued and issued != "adm"
        # a public bind refuses writes without a token
        with pytest.raises(urllib.error.HTTPError) as err:
            client_pkg.ForgeClient(server.url).delete("anything")
        assert err.value.code == 403
    finally:
        server.close()
    open_srv = server_pkg.ForgeServer(str(tmp_path / "store2"),
                                      host="0.0.0.0", token="adm",
                                      open_registration=True)
    try:
        assert client_pkg.ForgeClient(open_srv.url).register(
            "y@example.com")
    finally:
        open_srv.close()


def test_token_never_appears_in_a_url(tmp_path, monkeypatch):
    """Every request the port's client makes carries its token in the
    ``X-Forge-Token`` header only: no URL it opens holds the token, for
    every operation (upload, delete, thumbnail, fetch, list, details,
    unregister). The server still honours the legacy query fallback."""
    seen = []
    urlopen = urllib.request.urlopen

    def recording(req, *args, **kwargs):
        seen.append((req.full_url, dict(req.header_items())))
        return urlopen(req, *args, **kwargs)

    monkeypatch.setattr(P_client.urlrequest, "urlopen", recording)
    model = _model(tmp_path)
    server = P_forge.ForgeServer(str(tmp_path / "store"),
                                 token="admin-secret")
    try:
        client = P_forge.ForgeClient(server.url)
        token = client.register("carol@example.com")
        client.upload(str(model), "pkg")
        client.upload_thumbnail("pkg", b"png")
        client.fetch("pkg", str(tmp_path / "out"))
        client.list()
        client.details("pkg")
        client.delete("pkg")
        assert client.unregister("carol@example.com", token)
        assert len(seen) >= 8
        for url, headers in seen[1:]:
            assert token not in url, url
            assert headers.get("X-forge-token") == token
        # the legacy query-string fallback of old clients still works
        token2 = P_forge.ForgeClient(server.url).register(
            "carol@example.com")
        from urllib.parse import urlencode
        url = "%s/service?%s" % (server.url, urlencode(
            {"query": "unregister", "email": "carol@example.com",
             "token": token2}))
        with urlopen(url, timeout=10) as resp:
            assert json.load(resp)["ok"]
    finally:
        server.close()


def test_forge_cli(tmp_path, capsys):
    """``python -m veles_tpu_torch.forge``'s ``main`` against a
    reference server: upload, list, fetch, delete."""
    model = _model(tmp_path)
    server = R_forge.ForgeServer(str(tmp_path / "store"))
    try:
        main = P_client.main
        assert main(["-s", server.url, "upload", str(model), "-n", "pkg",
                     "-v", "3.0"]) == 0
        assert main(["-s", server.url, "list"]) == 0
        assert '"pkg"' in capsys.readouterr().out
        assert main(["-s", server.url, "fetch", "pkg", "-d",
                     str(tmp_path / "got")]) == 0
        assert (tmp_path / "got" / "weights.bin").exists()
        assert main(["-s", server.url, "delete", "pkg"]) == 0
        assert R_forge.ForgeClient(server.url).list() == []
    finally:
        server.close()


#: requests whose package or version name is not one normal component
BAD_NAMES = [
    ("POST", "/delete?name=.."), ("POST", "/delete?name=."),
    ("POST", "/delete?name="), ("POST", "/delete?name=a%2Fb"),
    ("POST", "/upload?name=..&version=1"),
    ("POST", "/upload?name=.&version=1"),
    ("POST", "/upload?name=pkg&version=.."),
    ("POST", "/upload?name=pkg&version=..%2F..%2Fx"),
    ("POST", "/upload?name=users.json&version=1"),
    ("POST", "/thumbnail?name=.."), ("POST", "/thumbnail?name=."),
    ("GET", "/thumbnail?name=.."), ("GET", "/fetch?name=..&version=1"),
    ("GET", "/fetch?name=pkg&version=..%2Fpkg%2F1.0"),
    ("GET", "/service?query=details&name=.."),
]


@pytest.mark.parametrize("method,path", BAD_NAMES,
                         ids=["%s %s" % case for case in BAD_NAMES])
def test_names_outside_the_store_answer_400(method, path, tmp_path):
    """The port's store takes a package or version name only as one
    normal path component: ``.``, ``..``, a separator or the users file
    answers 400, and nothing around the store is deleted or written
    (the reference keeps ``basename`` of the name, which lets ``..``
    reach ``rmtree`` of the store's parent)."""
    model = _model(tmp_path)
    parent = tmp_path / "forge"
    parent.mkdir()
    (parent / "keep.txt").write_text("keep")
    server = P_forge.ForgeServer(str(parent / "store"))
    try:
        client = P_forge.ForgeClient(server.url)
        client.upload(str(model), "pkg", version="1.0")
        before = sorted(p.relative_to(tmp_path)
                        for p in tmp_path.rglob("*"))
        req = urllib.request.Request(
            server.url + path, method=method,
            data=b"x" if method == "POST" else None)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 400
        assert sorted(p.relative_to(tmp_path)
                      for p in tmp_path.rglob("*")) == before
        assert (parent / "keep.txt").read_text() == "keep"
        assert client.details("pkg")["versions"] == ["1.0"]
    finally:
        server.close()

"""The port's worker-key auth (``vlog_tpu_torch.api.auth``) and its own
Argon2id (``native/argon2.c``) against the JAX package's (argon2-cffi).

- The hash: RFC 9106 §5.3's Argon2id test vector (secret and associated
  data included), and argon2-cffi's raw Argon2id tag on the same inputs
  at several costs and lane counts, byte for byte.
- PHC strings: one minted by argon2-cffi verifies in the port, one the
  port mints verifies in argon2-cffi; a wrong secret or a tampered
  string does not.
- Keys on one sqlite file: a key minted by ``vlog_tpu.api.auth`` verifies
  with the port, and the reverse; format, prefix lookup, last-used,
  revocation (both packages see it) and the verify cache.
"""

from __future__ import annotations

import pytest

from vlog_tpu_torch.api import auth as tauth

RFC9106_ARGON2ID_TAG = bytes.fromhex(
    "0d640df58d78766c08c037a34a8b53c9d01ef0452d75b65eb52520e96b01e659")


def test_rfc9106_argon2id_test_vector():
    tag = tauth.argon2id(b"\x01" * 32, b"\x02" * 16, t_cost=3, m_cost_kib=32,
                         parallelism=4, hash_len=32, secret=b"\x03" * 8,
                         ad=b"\x04" * 12)
    assert tag == RFC9106_ARGON2ID_TAG


@pytest.mark.parametrize("t,m,p,n", [(2, 65536, 1, 32), (1, 64, 2, 16),
                                     (3, 1024, 3, 32), (2, 4096, 4, 100)])
def test_raw_tag_equals_argon2_cffi(t, m, p, n):
    from argon2.low_level import Type, hash_secret_raw

    pwd, salt = b"vlwk secret", b"0123456789abcdef"
    want = hash_secret_raw(pwd, salt, t, m, p, n, Type.ID)
    assert tauth.argon2id(pwd, salt, t_cost=t, m_cost_kib=m, parallelism=p,
                          hash_len=n) == want


def test_phc_strings_cross_verify():
    from argon2 import PasswordHasher

    ph = PasswordHasher(time_cost=2, memory_cost=65536, parallelism=1)
    theirs = ph.hash("s3cret")
    assert tauth.verify_secret(theirs, "s3cret")
    assert not tauth.verify_secret(theirs, "s3cret!")
    ours = tauth.hash_secret("s3cret")
    assert ours.startswith("$argon2id$v=19$m=65536,t=2,p=1$")
    assert ph.verify(ours, "s3cret")
    for bad in (ours.replace("argon2id", "argon2i"), ours[:-4] + "AAAA",
                "$argon2id$v=19$m=x$y$z", "plain"):
        assert not tauth.verify_secret(bad, "s3cret")


def test_keys_cross_verify_on_one_database(run, db, db_path):
    """``db`` is the JAX package's connection to ``db_path``; the port
    opens the same file with its own Database."""
    from vlog_tpu.api import auth as jauth
    from vlog_tpu_torch.db import Database

    async def go():
        tdb = Database(f"sqlite:///{db_path}")
        await tdb.connect()
        try:
            jkey = await jauth.create_worker_key(db, "w-jax")
            tkey = await tauth.create_worker_key(tdb, "w-port")
            for key in (jkey, tkey):
                assert key.startswith("vlwk_") and len(key) == 5 + 8 + 64
            assert (await tauth.verify_key(tdb, jkey)).worker_name == "w-jax"
            assert (await jauth.verify_key(db, tkey)).worker_name == "w-port"
            rows = await tdb.fetch_all(
                "SELECT * FROM worker_api_keys ORDER BY id")
            for row, key in zip(rows, (jkey, tkey)):
                assert row["key_hash"].startswith("$argon2id$v=19$")
                assert key not in row["key_hash"]
                assert row["key_prefix"] == key[5:13]
            assert rows[0]["last_used_at"] is not None   # the port's verify
            assert await tauth.revoke_keys(tdb, "w-jax") == 1
            jauth.invalidate_verify_cache()
            with pytest.raises(jauth.AuthError):
                await jauth.verify_key(db, jkey)
            with pytest.raises(tauth.AuthError):
                await tauth.verify_key(tdb, jkey)
        finally:
            await tdb.disconnect()

    run(go())


def test_bad_keys_revocation_and_the_verify_cache(run, tmp_path):
    from vlog_tpu_torch.db import Database, create_all

    async def go():
        tdb = Database(f"sqlite:///{tmp_path / 'k.db'}")
        await tdb.connect()
        await create_all(tdb)
        try:
            key = await tauth.create_worker_key(tdb, "w1")
            for bad in (key[:-4] + "beef", "vlwk_short", "not-a-key"):
                with pytest.raises(tauth.AuthError):
                    await tauth.verify_key(tdb, bad)
            ident = await tauth.verify_key(tdb, key)
            assert ident.worker_name == "w1"
            # cached: a row revoked behind the cache's back still
            # verifies until the TTL or an invalidation
            await tdb.execute("UPDATE worker_api_keys SET revoked_at=1")
            assert await tauth.verify_key(tdb, key) == ident
            tauth.invalidate_verify_cache()
            with pytest.raises(tauth.AuthError, match="revoked"):
                await tauth.verify_key(tdb, key)
            key2 = await tauth.create_worker_key(tdb, "w1")
            await tauth.verify_key(tdb, key2)
            assert await tauth.revoke_keys(tdb, "w1") == 1   # drops cache
            with pytest.raises(tauth.AuthError):
                await tauth.verify_key(tdb, key2)
        finally:
            tauth.invalidate_verify_cache()
            await tdb.disconnect()

    run(go())


def test_admin_secret_check():
    assert tauth.check_admin_secret(None, "")          # dev mode
    assert tauth.check_admin_secret("s3cret", "s3cret")
    assert not tauth.check_admin_secret("wrong", "s3cret")
    assert not tauth.check_admin_secret(None, "s3cret")

"""Carried from olavm_tpu/state/store.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Durable key-value store with column families — the RocksDB wrapper
equivalent (reference core/src/storage/db.rs:19-273, Database::MerkleTree /
Sequencer / StateKeeper roles). Backed by sqlite3 (stdlib) so state survives
restarts without external dependencies; an in-memory mode (path=None) serves
tests like the reference's tempdir DBs."""

from __future__ import annotations

import sqlite3


class Database:
    MERKLE_TREE = "merkle_tree"
    SEQUENCER = "sequencer"
    STATE_KEEPER = "state_keeper"


# column families per role (db.rs:202-215)
COLUMN_FAMILIES = {
    Database.MERKLE_TREE: ["default", "tree", "leaf_index", "metadata"],
    Database.SEQUENCER: [
        "default", "contracts", "contract_map", "prophets", "debug_info",
        "state",
    ],
    Database.STATE_KEEPER: ["default", "state"],
}


class KVStore:
    """get/put/multi_get/write_batch over named column families."""

    def __init__(self, role: str, path: str | None = None):
        self.role = role
        self.path = path or ":memory:"
        self.conn = sqlite3.connect(self.path)
        self.cfs = COLUMN_FAMILIES[role]
        for cf in self.cfs:
            self.conn.execute(
                f"CREATE TABLE IF NOT EXISTS cf_{cf} "
                "(k BLOB PRIMARY KEY, v BLOB)"
            )
        self.conn.commit()

    def get(self, cf: str, key: bytes) -> bytes | None:
        cur = self.conn.execute(f"SELECT v FROM cf_{cf} WHERE k = ?", (key,))
        row = cur.fetchone()
        return row[0] if row else None

    def put(self, cf: str, key: bytes, value: bytes):
        self.conn.execute(
            f"INSERT OR REPLACE INTO cf_{cf} (k, v) VALUES (?, ?)", (key, value)
        )
        self.conn.commit()

    def multi_get(self, cf: str, keys: list[bytes]) -> list[bytes | None]:
        return [self.get(cf, k) for k in keys]

    def write_batch(self, items: list[tuple[str, bytes, bytes]]):
        """items: (cf, key, value) triples committed atomically."""
        with self.conn:
            for cf, k, v in items:
                self.conn.execute(
                    f"INSERT OR REPLACE INTO cf_{cf} (k, v) VALUES (?, ?)",
                    (k, v),
                )

    def iter_cf(self, cf: str):
        yield from self.conn.execute(f"SELECT k, v FROM cf_{cf}")

    def close(self):
        self.conn.close()

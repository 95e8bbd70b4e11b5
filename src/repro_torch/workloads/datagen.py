"""Deterministic synthetic datasets shaped like the paper's three DBs.

IMDb-like (relational, join-heavy), FineWiki-like (point lookups over
page records), TPC-H-like (analytical aggregates).  Sizes are scaled to
CPU-runnable defaults but keep the relative shapes (lineitem largest,
crew a many-to-many bridge, pages indexed by title).

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import random

from repro_torch.workloads.minidb import MiniDB

GENRES = ["drama", "comedy", "action", "thriller", "scifi", "horror",
          "romance", "documentary"]
ROLES = ["actor", "director", "writer", "producer"]
MARKETS = ["us", "eu", "apac", "latam", "mea"]
SEGMENTS = ["building", "automobile", "machinery", "household", "furniture"]
FLAGS = ["A", "N", "R"]


def load_imdb(db: MiniDB, scale: int = 1, seed: int = 7) -> None:
    rng = random.Random(seed)
    n_titles, n_people = 4000 * scale, 2000 * scale
    titles = [(i, f"title_{i}", 1950 + rng.randrange(75),
               GENRES[rng.randrange(len(GENRES))],
               round(rng.uniform(1.0, 10.0), 1))
              for i in range(n_titles)]
    people = [(i, f"person_{i}", 1920 + rng.randrange(90))
              for i in range(n_people)]
    crew = []
    for t in range(n_titles):
        for _ in range(rng.randrange(3, 8)):
            crew.append((t, rng.randrange(n_people),
                         ROLES[rng.randrange(len(ROLES))]))
    db.create_table("titles", ["id", "title", "year", "genre", "rating"], titles)
    db.create_table("people", ["id", "name", "born"], people)
    db.create_table("crew", ["title_id", "person_id", "role"], crew)
    db.create_index("titles", "id")
    db.create_index("titles", "genre")
    db.create_index("people", "id")
    db.create_index("crew", "title_id")
    db.create_index("crew", "person_id")


def load_finewiki(db: MiniDB, scale: int = 1, seed: int = 11) -> None:
    rng = random.Random(seed)
    n_pages = 20000 * scale
    pages = []
    for i in range(n_pages):
        words = " ".join(f"w{rng.randrange(5000)}" for _ in range(20))
        pages.append((i, f"page_{i}", words, rng.randrange(1, 100000),
                      GENRES[rng.randrange(len(GENRES))]))
    db.create_table("pages", ["id", "title", "body", "views", "topic"], pages)
    db.create_index("pages", "id")
    db.create_index("pages", "title")


def load_tpch(db: MiniDB, scale: int = 1, seed: int = 13) -> None:
    rng = random.Random(seed)
    n_cust, n_orders, n_items = 1500 * scale, 15000 * scale, 60000 * scale
    customers = [(i, f"cust_{i}", MARKETS[rng.randrange(len(MARKETS))],
                  SEGMENTS[rng.randrange(len(SEGMENTS))])
                 for i in range(n_cust)]
    orders = [(i, rng.randrange(n_cust),
               f"199{rng.randrange(8)}-{rng.randrange(1,13):02d}-01",
               round(rng.uniform(1e3, 5e5), 2))
              for i in range(n_orders)]
    lineitem = []
    for i in range(n_items):
        lineitem.append((
            i, rng.randrange(n_orders),
            rng.randrange(1, 50),                       # quantity
            round(rng.uniform(100.0, 10000.0), 2),      # price
            round(rng.uniform(0.0, 0.1), 2),            # discount
            FLAGS[rng.randrange(len(FLAGS))],           # returnflag
            f"199{rng.randrange(8)}-{rng.randrange(1,13):02d}-15"))
    db.create_table("customer", ["id", "name", "market", "segment"], customers)
    db.create_table("orders", ["id", "cust_id", "orderdate", "totalprice"], orders)
    db.create_table("lineitem",
                    ["id", "order_id", "quantity", "price", "discount",
                     "returnflag", "shipdate"], lineitem)
    db.create_index("customer", "id")
    db.create_index("customer", "market")
    db.create_index("orders", "id")
    db.create_index("orders", "cust_id")
    db.create_index("lineitem", "order_id")
    db.create_index("lineitem", "returnflag")


def build_database(which: str, scale: int = 1) -> MiniDB:
    db = MiniDB()
    if which == "imdb":
        load_imdb(db, scale)
    elif which == "finewiki":
        load_finewiki(db, scale)
    elif which == "tpch":
        load_tpch(db, scale)
    elif which == "all":
        load_imdb(db, scale)
        load_finewiki(db, scale)
        load_tpch(db, scale)
    else:
        raise ValueError(which)
    return db

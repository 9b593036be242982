"""Port copy of ``trino_tpu/sql/parser.py`` (no edits beyond import targets
noted inline).

Recursive-descent SQL parser.

Reference: core/trino-parser/.../parser/SqlParser.java:53 drives an ANTLR
grammar (SqlBase.g4, 1,467 lines) and AstBuilder lowers to the AST. We parse
the executed subset directly — queries with joins, subqueries, aggregates,
CASE/CAST/EXTRACT/LIKE/IN/BETWEEN, ORDER BY / LIMIT, EXPLAIN — with the same
operator precedence as the reference grammar.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import ast_nodes as A
from .tokenizer import SqlSyntaxError, Token, tokenize

RESERVED_STOPPERS = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "ON", "JOIN",
    "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "AND", "OR", "NOT", "AS",
    "BY", "ASC", "DESC", "UNION", "EXCEPT", "INTERSECT", "SELECT", "THEN",
    "WHEN", "ELSE", "END", "IS", "IN", "LIKE", "BETWEEN", "NULLS", "FIRST",
    "LAST", "EXISTS", "CASE", "DISTINCT", "WITH",
}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.tokens: List[Token] = tokenize(sql)
        self.i = 0

    # ---- token helpers ----------------------------------------------------

    def peek(self, offset: int = 0) -> Token:
        return self.tokens[min(self.i + offset, len(self.tokens) - 1)]

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "name" and t.text in words

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.text in ops

    def advance(self) -> Token:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def accept_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.advance()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.advance()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.accept_kw(word):
            self.fail(f"expected {word}, found {self.peek().raw!r}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            self.fail(f"expected {op!r}, found {self.peek().raw!r}")

    def fail(self, message: str):
        raise SqlSyntaxError(message, self.sql, self.peek().pos)

    # ---- entry points -----------------------------------------------------

    def parse_statement(self) -> A.Node:
        if self.accept_kw("EXPLAIN"):
            analyze = self.accept_kw("ANALYZE")
            if self.at_kw("CREATE"):
                q: A.Node = self.parse_create_table()
            elif self.accept_kw("INSERT"):
                self.expect_kw("INTO")
                q = A.InsertInto(tuple(self.qualified_name()),
                                 self.parse_query())
            else:
                q = self.parse_query()
            node: A.Node = A.Explain(q, analyze)
        elif self.at_kw("SHOW"):
            node = self.parse_show()
        elif self.accept_kw("DESCRIBE") or self.accept_kw("DESC"):
            node = A.ShowColumns(tuple(self.qualified_name()))
        elif self.accept_kw("SET"):
            self.expect_kw("SESSION")
            name = ".".join(self.qualified_name())
            self.expect_op("=")
            node = A.SetSession(name, self.parse_expr())
        elif self.at_kw("CREATE"):
            node = self.parse_create_table()
        elif self.accept_kw("DROP"):
            self.expect_kw("TABLE")
            if_exists = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            node = A.DropTable(tuple(self.qualified_name()), if_exists)
        elif self.accept_kw("INSERT"):
            self.expect_kw("INTO")
            table = tuple(self.qualified_name())
            node = A.InsertInto(table, self.parse_query())
        elif self.accept_kw("UPDATE"):
            node = self.parse_update()
        elif self.accept_kw("DELETE"):
            self.expect_kw("FROM")
            table = tuple(self.qualified_name())
            where = self.parse_expr() if self.accept_kw("WHERE") else None
            node = A.Delete(table, where)
        elif self.accept_kw("MERGE"):
            node = self.parse_merge()
        else:
            node = self.parse_query()
        self.accept_op(";")
        if self.peek().kind != "eof":
            self.fail(f"unexpected trailing input {self.peek().raw!r}")
        return node

    def parse_create_table(self) -> A.Node:
        self.expect_kw("CREATE")
        self.expect_kw("TABLE")
        if_not_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            if_not_exists = True
        table = tuple(self.qualified_name())
        if self.accept_kw("AS"):
            return A.CreateTable(table, (), self.parse_query(),
                                 if_not_exists)
        self.expect_op("(")
        cols = []
        while True:
            name = self.advance()
            if name.kind not in ("name", "qident"):
                self.fail("expected column name")
            cols.append((name.raw if name.kind == "qident"
                         else name.text.lower(), self.parse_type_name()))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return A.CreateTable(table, tuple(cols), None, if_not_exists)

    def parse_show(self) -> A.Node:
        self.expect_kw("SHOW")
        if self.accept_kw("TABLES"):
            catalog = schema = None
            if self.accept_kw("FROM") or self.accept_kw("IN"):
                parts = self.qualified_name()
                if len(parts) == 2:
                    catalog, schema = parts
                else:
                    schema = parts[0]
            return A.ShowTables(catalog, schema)
        if self.accept_kw("CATALOGS"):
            return A.ShowCatalogs()
        if self.accept_kw("SCHEMAS"):
            catalog = None
            if self.accept_kw("FROM") or self.accept_kw("IN"):
                catalog = self.qualified_name()[0]
            return A.ShowSchemas(catalog)
        if self.accept_kw("SESSION"):
            return A.ShowSession()
        if self.accept_kw("COLUMNS"):
            self.expect_kw("FROM")
            return A.ShowColumns(tuple(self.qualified_name()))
        self.fail("unsupported SHOW statement")

    def parse_query(self) -> A.Node:
        """queryNoWith: WITH? set-op chain (ORDER BY)? (LIMIT)?
        (SqlBase.g4 query/queryNoWith/queryTerm structure)."""
        ctes = []
        if self.accept_kw("WITH"):
            while True:
                t = self.advance()
                if t.kind != "name":
                    self.fail("expected CTE name after WITH")
                self.expect_kw("AS")
                self.expect_op("(")
                cq = self.parse_query()
                self.expect_op(")")
                ctes.append((t.raw, cq))
                if not self.accept_op(","):
                    break

        body = self.parse_set_body()

        order_by: Tuple[A.OrderItem, ...] = ()
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            items_o = [self.order_item()]
            while self.accept_op(","):
                items_o.append(self.order_item())
            order_by = tuple(items_o)

        limit = None
        if self.accept_kw("LIMIT"):
            t = self.advance()
            if t.kind != "number":
                self.fail("LIMIT expects a number")
            limit = int(t.text)

        import dataclasses
        if isinstance(body, A.Values):
            # bare VALUES statement: wrap as SELECT * FROM (VALUES ...)
            body = A.Query((A.SelectItem(expr=None),), False,
                           A.ValuesRef(body, "values"), None, (), None,
                           (), None)
        if isinstance(body, (A.Query, A.SetOp)):
            inner_has = body.order_by or body.limit is not None or body.ctes
            outer_has = order_by or limit is not None or ctes
            if not outer_has:
                return body       # parenthesized query keeps its clauses
            if inner_has:
                # both levels have clauses: outer wraps the parenthesized
                # body as a derived table so neither is lost
                body = A.Query((A.SelectItem(expr=None),), False,
                               A.SubqueryRef(body, "$sub"), None, (), None,
                               (), None)
            return dataclasses.replace(body, order_by=order_by, limit=limit,
                                       ctes=tuple(ctes))
        self.fail("malformed query body")

    def parse_set_body(self) -> A.Node:
        left = self.parse_set_term()
        while self.at_kw("UNION", "EXCEPT"):
            op = self.advance().text.lower()
            all_rows = self.accept_kw("ALL")
            if not all_rows:
                self.accept_kw("DISTINCT")
            left = A.SetOp(op, all_rows, left, self.parse_set_term())
        return left

    def parse_set_term(self) -> A.Node:
        left = self.parse_set_primary()
        while self.at_kw("INTERSECT"):
            self.advance()
            all_rows = self.accept_kw("ALL")
            if not all_rows:
                self.accept_kw("DISTINCT")
            left = A.SetOp("intersect", all_rows, left,
                           self.parse_set_primary())
        return left

    def parse_set_primary(self) -> A.Node:
        if self.accept_op("("):
            q = self.parse_query()
            self.expect_op(")")
            return q
        if self.at_kw("VALUES"):
            return self.parse_values()
        return self.parse_select_core()

    def parse_values(self) -> A.Values:
        self.expect_kw("VALUES")
        rows = []
        while True:
            if self.accept_op("("):
                row = [self.parse_expr()]
                while self.accept_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
            else:
                row = [self.parse_expr()]
            rows.append(tuple(row))
            if not self.accept_op(","):
                break
        return A.Values(tuple(rows))

    def parse_select_core(self) -> A.Query:
        """One SELECT..HAVING block (querySpecification in SqlBase.g4);
        ORDER BY / LIMIT / WITH belong to the enclosing query."""
        self.expect_kw("SELECT")
        distinct = self.accept_kw("DISTINCT")
        self.accept_kw("ALL")
        select = [self.select_item()]
        while self.accept_op(","):
            select.append(self.select_item())

        relation = None
        if self.accept_kw("FROM"):
            relation = self.parse_relation()

        where = self.parse_expr() if self.accept_kw("WHERE") else None

        group_by: Tuple[A.Node, ...] = ()
        grouping_sets: Tuple = ()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            group_by, grouping_sets = self.parse_group_by()

        having = self.parse_expr() if self.accept_kw("HAVING") else None

        return A.Query(tuple(select), distinct, relation, where, group_by,
                       having, (), None, (), grouping_sets)

    def parse_group_by(self):
        """GROUP BY exprs | ROLLUP(..) | CUBE(..) | GROUPING SETS((..),..).
        Returns (distinct exprs, sets of indexes into them); plain GROUP BY
        yields no sets (single implicit full set)."""
        if self.accept_kw("ROLLUP"):
            self.expect_op("(")
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            sets = tuple(tuple(range(k))
                         for k in range(len(items), -1, -1))
            return tuple(items), sets
        if self.accept_kw("CUBE"):
            self.expect_op("(")
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            n = len(items)
            sets = tuple(tuple(i for i in range(n) if mask & (1 << i))
                         for mask in range((1 << n) - 1, -1, -1))
            return tuple(items), sets
        if self.accept_kw("GROUPING"):
            self.expect_kw("SETS")
            self.expect_op("(")
            raw_sets = []
            items: list = []

            def parse_one_set():
                exprs = []
                if self.accept_op("("):
                    if not self.at_op(")"):
                        exprs.append(self.parse_expr())
                        while self.accept_op(","):
                            exprs.append(self.parse_expr())
                    self.expect_op(")")
                else:
                    exprs.append(self.parse_expr())
                idxs = []
                for e in exprs:
                    if e not in items:
                        items.append(e)
                    idxs.append(items.index(e))
                raw_sets.append(tuple(idxs))

            parse_one_set()
            while self.accept_op(","):
                parse_one_set()
            self.expect_op(")")
            return tuple(items), tuple(raw_sets)
        items = [self.parse_expr()]
        while self.accept_op(","):
            items.append(self.parse_expr())
        return tuple(items), ()

    # ---- select items / order items --------------------------------------

    def select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.advance()
            return A.SelectItem(expr=None)
        # t.* / schema.t.*
        save = self.i
        if self.peek().kind in ("name", "qident"):
            t = self.advance()
            parts = [t.raw if t.kind == "name" else t.text]
            matched_star = False
            while self.at_op("."):
                nxt = self.peek(1)
                if nxt.kind == "op" and nxt.text == "*":
                    self.advance()
                    self.advance()
                    matched_star = True
                    break
                if nxt.kind in ("name", "qident"):
                    self.advance()
                    t = self.advance()
                    parts.append(t.raw if t.kind == "name" else t.text)
                else:
                    break
            if matched_star:
                return A.SelectItem(expr=None,
                                    star_qualifier=tuple(parts))
            self.i = save
        expr = self.parse_expr()
        alias = self.maybe_alias()
        return A.SelectItem(expr=expr, alias=alias)

    def maybe_alias(self) -> Optional[str]:
        if self.accept_kw("AS"):
            t = self.advance()
            if t.kind not in ("name", "qident"):
                self.fail("expected alias")
            return t.raw if t.kind == "name" else t.raw[1:-1]
        t = self.peek()
        if t.kind == "qident":
            self.advance()
            return t.text
        if t.kind == "name" and t.text not in RESERVED_STOPPERS:
            self.advance()
            return t.raw
        return None

    def order_item(self) -> A.OrderItem:
        expr = self.parse_expr()
        asc = True
        if self.accept_kw("ASC"):
            asc = True
        elif self.accept_kw("DESC"):
            asc = False
        nulls_first = None
        if self.accept_kw("NULLS"):
            if self.accept_kw("FIRST"):
                nulls_first = True
            else:
                self.expect_kw("LAST")
                nulls_first = False
        return A.OrderItem(expr, asc, nulls_first)

    # ---- relations --------------------------------------------------------

    def parse_update(self) -> A.Node:
        table = tuple(self.qualified_name())
        self.expect_kw("SET")
        assignments = []
        while True:
            col = self.qualified_name()[-1].lower()
            self.expect_op("=")
            assignments.append((col, self.parse_expr()))
            if not self.accept_op(","):
                break
        where = self.parse_expr() if self.accept_kw("WHERE") else None
        return A.Update(table, tuple(assignments), where)

    def parse_merge(self) -> A.Node:
        self.expect_kw("INTO")
        target = tuple(self.qualified_name())
        target_alias = None
        self.accept_kw("AS")
        if self.peek().kind in ("name", "qident") and \
                not self.at_kw("USING"):
            target_alias = self.qualified_name()[0].lower()
        self.expect_kw("USING")
        source = self.table_primary()
        self.expect_kw("ON")
        on = self.parse_expr()
        clauses = []
        while self.accept_kw("WHEN"):
            matched = not self.accept_kw("NOT")
            self.expect_kw("MATCHED")
            cond = self.parse_expr() if self.accept_kw("AND") else None
            self.expect_kw("THEN")
            if self.accept_kw("UPDATE"):
                self.expect_kw("SET")
                assignments = []
                while True:
                    col = self.qualified_name()[-1].lower()
                    self.expect_op("=")
                    assignments.append((col, self.parse_expr()))
                    if not self.accept_op(","):
                        break
                clauses.append(A.MergeClause(matched, cond, "update",
                                             tuple(assignments)))
            elif self.accept_kw("DELETE"):
                clauses.append(A.MergeClause(matched, cond, "delete"))
            else:
                self.expect_kw("INSERT")
                cols = []
                if self.accept_op("("):
                    while True:
                        cols.append(self.qualified_name()[-1].lower())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                self.expect_kw("VALUES")
                self.expect_op("(")
                vals = [self.parse_expr()]
                while self.accept_op(","):
                    vals.append(self.parse_expr())
                self.expect_op(")")
                clauses.append(A.MergeClause(matched, cond, "insert",
                                             insert_columns=tuple(cols),
                                             insert_values=tuple(vals)))
        if not clauses:
            self.fail("MERGE requires at least one WHEN clause")
        return A.MergeInto(target, target_alias, source, on,
                           tuple(clauses))

    def parse_relation(self) -> A.Node:
        left = self.join_chain()
        while self.accept_op(","):
            right = self.join_chain()
            left = A.Join("cross", left, right, None)
        return left

    def join_chain(self) -> A.Node:
        left = self.table_primary()
        while True:
            if self.accept_kw("CROSS"):
                self.expect_kw("JOIN")
                right = self.table_primary()
                left = A.Join("cross", left, right, None)
                continue
            kind = None
            if self.at_kw("JOIN") or self.at_kw("INNER"):
                self.accept_kw("INNER")
                self.expect_kw("JOIN")
                kind = "inner"
            elif self.at_kw("LEFT"):
                self.advance()
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "left"
            elif self.at_kw("RIGHT"):
                self.advance()
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "right"
            elif self.at_kw("FULL"):
                self.advance()
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "full"
            else:
                return left
            right = self.table_primary()
            self.expect_kw("ON")
            cond = self.parse_expr()
            left = A.Join(kind, left, right, cond)

    def table_primary(self) -> A.Node:
        if self.at_kw("UNNEST"):
            self.advance()
            self.expect_op("(")
            arg = self.parse_expr()
            self.expect_op(")")
            ordinality = False
            if self.accept_kw("WITH"):
                self.expect_kw("ORDINALITY")
                ordinality = True
            alias, colnames = self.table_alias_with_columns()
            return A.UnnestRef(arg, alias, colnames, ordinality)
        if self.accept_op("("):
            if self.at_kw("VALUES"):
                v = self.parse_values()
                self.expect_op(")")
                alias, colnames = self.table_alias_with_columns()
                return A.ValuesRef(v, alias or "values", colnames)
            if self.at_kw("SELECT", "WITH"):
                q = self.parse_query()
                self.expect_op(")")
                self.accept_kw("AS")
                t = self.advance()
                if t.kind not in ("name", "qident"):
                    self.fail("derived table requires an alias")
                return A.SubqueryRef(q, t.raw if t.kind == "name"
                                     else t.raw[1:-1])
            if self.at_op("("):
                # '((...' — either a parenthesized set operation used as
                # a derived table, or a parenthesized join relation:
                # try the query grammar first, backtrack on failure
                mark = self.i
                try:
                    q = self.parse_query()
                    self.expect_op(")")
                    alias = self.maybe_alias()
                    return A.SubqueryRef(q, alias or "$setop")
                except SqlSyntaxError:
                    self.i = mark
            rel = self.parse_relation()
            self.expect_op(")")
            return rel
        parts = self.qualified_name()
        alias = self.maybe_alias()
        return A.TableRef(tuple(parts), alias)

    def table_alias_with_columns(self):
        """[AS] alias [(col, col, ...)] after a derived table."""
        alias = self.maybe_alias()
        colnames = None
        if alias is not None and self.accept_op("("):
            names = []
            while True:
                t = self.advance()
                if t.kind not in ("name", "qident"):
                    self.fail("expected column name in table alias")
                names.append(t.raw if t.kind == "name" else t.text)
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            colnames = tuple(names)
        return alias, colnames

    def qualified_name(self) -> List[str]:
        t = self.advance()
        if t.kind not in ("name", "qident"):
            self.fail("expected name")
        parts = [t.raw if t.kind == "name" else t.text]
        while self.at_op(".") and self.peek(1).kind in ("name", "qident"):
            self.advance()
            t = self.advance()
            parts.append(t.raw if t.kind == "name" else t.text)
        return parts

    # ---- expressions (precedence climbing) --------------------------------

    def parse_expr(self) -> A.Node:
        return self.parse_or()

    def parse_or(self) -> A.Node:
        left = self.parse_and()
        while self.accept_kw("OR"):
            left = A.BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> A.Node:
        left = self.parse_not()
        while self.accept_kw("AND"):
            left = A.BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> A.Node:
        if self.accept_kw("NOT"):
            return A.UnaryOp("not", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> A.Node:
        left = self.parse_additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.advance().text
                if op == "!=":
                    op = "<>"
                right = self.parse_additive()
                left = A.BinaryOp(op, left, right)
                continue
            if self.at_kw("IS"):
                self.advance()
                negated = self.accept_kw("NOT")
                self.expect_kw("NULL")
                left = A.IsNullPredicate(left, negated)
                continue
            negated = False
            save = self.i
            if self.accept_kw("NOT"):
                negated = True
            if self.accept_kw("BETWEEN"):
                low = self.parse_additive()
                self.expect_kw("AND")
                high = self.parse_additive()
                left = A.BetweenPredicate(left, low, high, negated)
                continue
            if self.accept_kw("IN"):
                self.expect_op("(")
                if self.at_kw("SELECT"):
                    q = self.parse_query()
                    self.expect_op(")")
                    left = A.InSubquery(left, q, negated)
                else:
                    vals = [self.parse_expr()]
                    while self.accept_op(","):
                        vals.append(self.parse_expr())
                    self.expect_op(")")
                    left = A.InPredicate(left, tuple(vals), negated)
                continue
            if self.accept_kw("LIKE"):
                pattern = self.parse_additive()
                escape = None
                if self.accept_kw("ESCAPE"):
                    escape = self.parse_additive()
                left = A.LikePredicate(left, pattern, escape, negated)
                continue
            if negated:
                self.i = save
            return left

    def parse_additive(self) -> A.Node:
        left = self.parse_multiplicative()
        while self.at_op("+", "-") or self.at_op("||"):
            op = self.advance().text
            left = A.BinaryOp(op, left, self.parse_multiplicative())
        return left

    def parse_multiplicative(self) -> A.Node:
        left = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.advance().text
            left = A.BinaryOp(op, left, self.parse_unary())
        return left

    def parse_unary(self) -> A.Node:
        if self.accept_op("-"):
            return A.UnaryOp("-", self.parse_unary())
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> A.Node:
        t = self.peek()

        if t.kind == "number":
            self.advance()
            return A.NumberLit(t.text)
        if t.kind == "string":
            self.advance()
            return A.StringLit(t.text)

        if self.accept_op("("):
            if self.at_kw("SELECT"):
                q = self.parse_query()
                self.expect_op(")")
                return A.ScalarSubquery(q)
            e = self.parse_expr()
            self.expect_op(")")
            return e

        if t.kind != "name" and t.kind != "qident":
            self.fail(f"unexpected token {t.raw!r}")

        # keyword-introduced primaries
        if self.at_kw("ARRAY") and \
                self.peek(1).kind == "op" and self.peek(1).text == "[":
            self.advance()
            self.expect_op("[")
            items = []
            if not self.at_op("]"):
                items.append(self.parse_expr())
                while self.accept_op(","):
                    items.append(self.parse_expr())
            self.expect_op("]")
            return A.ArrayLiteral(tuple(items))
        if self.accept_kw("TRUE"):
            return A.BoolLit(True)
        if self.accept_kw("FALSE"):
            return A.BoolLit(False)
        if self.accept_kw("NULL"):
            return A.NullLit()
        if self.accept_kw("DATE"):
            s = self.advance()
            if s.kind != "string":
                self.fail("DATE expects a string literal")
            return A.DateLit(s.text)
        if self.accept_kw("TIMESTAMP"):
            s = self.advance()
            if s.kind != "string":
                self.fail("TIMESTAMP expects a string literal")
            return A.TimestampLit(s.text)
        if self.accept_kw("INTERVAL"):
            neg = False
            if self.accept_op("-"):
                neg = True
            s = self.advance()
            if s.kind != "string":
                self.fail("INTERVAL expects a string literal")
            unit_t = self.advance()
            unit = unit_t.text.lower().rstrip("s")
            if unit not in ("year", "month", "day"):
                self.fail(f"unsupported interval unit {unit_t.raw!r}")
            return A.IntervalLit(int(s.text), unit, neg)
        if self.accept_kw("CASE"):
            return self.parse_case()
        if self.accept_kw("CAST"):
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("AS")
            type_name = self.parse_type_name()
            self.expect_op(")")
            return A.CastExpr(e, type_name)
        if self.accept_kw("EXTRACT"):
            self.expect_op("(")
            part_t = self.advance()
            part = part_t.text.lower()
            if part not in ("year", "month", "day", "hour", "minute",
                            "second"):
                self.fail(f"unsupported EXTRACT part {part_t.raw!r}")
            self.expect_kw("FROM")
            e = self.parse_expr()
            self.expect_op(")")
            return A.ExtractExpr(part, e)
        if self.accept_kw("EXISTS"):
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return A.ExistsPredicate(q, negated=False)
        if self.accept_kw("SUBSTRING") or self.accept_kw("SUBSTR"):
            self.expect_op("(")
            e = self.parse_expr()
            if self.accept_kw("FROM"):
                start = self.parse_expr()
                length = self.parse_expr() if self.accept_kw("FOR") else None
            else:
                self.expect_op(",")
                start = self.parse_expr()
                length = self.parse_expr() if self.accept_op(",") else None
            self.expect_op(")")
            args = (e, start) + ((length,) if length is not None else ())
            return A.FunctionCall("substring", args)

        # function call or column reference
        if self.peek(1).kind == "op" and self.peek(1).text == "(" and \
                t.kind == "name":
            name = self.advance().text.lower()
            self.expect_op("(")
            if self.accept_op("*"):
                self.expect_op(")")
                if self.at_kw("OVER"):
                    return self.parse_over(name, (), is_star=True)
                return A.FunctionCall(name, (), is_star=True)
            distinct = self.accept_kw("DISTINCT")
            args: Tuple[A.Node, ...] = ()
            if not self.at_op(")"):
                lst = [self.parse_expr()]
                while self.accept_op(","):
                    lst.append(self.parse_expr())
                args = tuple(lst)
            self.expect_op(")")
            if self.at_kw("OVER"):
                if distinct:
                    self.fail("DISTINCT window aggregates unsupported")
                return self.parse_over(name, args, is_star=False)
            return A.FunctionCall(name, args, distinct=distinct)

        if t.kind == "name" and t.text in RESERVED_STOPPERS:
            self.fail(f"unexpected keyword {t.raw!r}")
        parts = self.qualified_name()
        return A.Identifier(tuple(parts))

    def parse_over(self, name: str, args, is_star: bool) -> A.Node:
        """OVER (PARTITION BY ... ORDER BY ... [ROWS|RANGE frame])
        (SqlBase.g4 windowSpecification)."""
        self.expect_kw("OVER")
        self.expect_op("(")
        partition: Tuple[A.Node, ...] = ()
        order: Tuple[A.OrderItem, ...] = ()
        frame = None
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            lst = [self.parse_expr()]
            while self.accept_op(","):
                lst.append(self.parse_expr())
            partition = tuple(lst)
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            items = [self.order_item()]
            while self.accept_op(","):
                items.append(self.order_item())
            order = tuple(items)
        if self.at_kw("ROWS") or self.at_kw("RANGE"):
            unit = self.advance().text.lower()

            def bound() -> str:
                if self.accept_kw("UNBOUNDED"):
                    if self.accept_kw("PRECEDING"):
                        return "unbounded_preceding"
                    self.expect_kw("FOLLOWING")
                    return "unbounded_following"
                if self.peek().kind == "number":
                    raw = self.advance().text
                    try:
                        k = int(raw)
                    except ValueError:
                        self.fail(f"frame bound must be an integer, "
                                  f"got {raw!r}")
                    if self.accept_kw("PRECEDING"):
                        return f"{k}_preceding"
                    self.expect_kw("FOLLOWING")
                    return f"{k}_following"
                self.expect_kw("CURRENT")
                self.expect_kw("ROW")
                return "current_row"

            if self.accept_kw("BETWEEN"):
                start = bound()
                self.expect_kw("AND")
                end = bound()
            else:
                start = bound()
                end = "current_row"
            frame = A.WindowFrame(unit, start, end)
        self.expect_op(")")
        return A.WindowFunc(name, args, is_star, partition, order, frame)

    def parse_case(self) -> A.Node:
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        whens = []
        while self.accept_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            val = self.parse_expr()
            whens.append((cond, val))
        default = self.parse_expr() if self.accept_kw("ELSE") else None
        self.expect_kw("END")
        if not whens:
            self.fail("CASE requires at least one WHEN")
        return A.CaseExpr(operand, tuple(whens), default)

    def parse_type_name(self) -> str:
        t = self.advance()
        if t.kind != "name":
            self.fail("expected type name")
        name = t.text.lower()
        if name in ("double", "bigint", "integer", "int", "boolean", "date",
                    "timestamp", "varchar", "real", "smallint", "tinyint"):
            if name == "double" and self.accept_kw("PRECISION"):
                pass
            return "double" if name == "real" else name
        if name == "decimal" or name == "numeric":
            if self.accept_op("("):
                p = int(self.advance().text)
                s = 0
                if self.accept_op(","):
                    s = int(self.advance().text)
                self.expect_op(")")
                return f"decimal({p},{s})"
            return "decimal(18,0)"
        self.fail(f"unsupported type {t.raw!r}")


def parse(sql: str) -> A.Node:
    """Parse one SQL statement (SqlParser.createStatement equivalent)."""
    return Parser(sql).parse_statement()

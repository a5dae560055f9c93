// Fast VM executor for the hot benchmark path — replaces the Python
// fetch-decode-execute loop (olavm_tpu/runtime/process.py, reference
// executor/src/lib.rs:2074-2310) for programs made of the 23 "plain"
// opcodes (arith/logic/memory/tape/control). Storage, poseidon, sccall and
// sigcheck fall back to the Python executor; prophets pause back into
// Python (which reads registers/memory and writes the psp region through
// the exported mem APIs), then resume.
//
// Emits the per-row columns the vectorized trace generators consume:
//   cpu rows      (n, CPU_FIELDS) u64  — main + ext lines, in order
//   memory table  (n, 16) u64          — final sorted rows with diff cols
//                                         (executor/src/trace.rs:20-200)
//   rangecheck    (n, 2) u64           — (value, filter_code), exec rows
//                                         then memory rows
//   bitwise       (n, 4), cmp (n, 4), tape (n, 6) u64
//
// Field arithmetic: Goldilocks p = 2^64 - 2^32 + 1 via __uint128_t.

#include <cstdint>
#include <cstring>
#include <map>
#include <unordered_map>
#include <vector>

typedef uint64_t u64;
typedef __uint128_t u128;
typedef int64_t i64;

static const u64 P = 0xFFFFFFFF00000001ull;
static const u64 MEM_SPAN = 0xFFFFFFFFull;
static const u64 PSP_START = P - MEM_SPAN;
static const u64 HP_START = P - 2 * MEM_SPAN;
static const u64 U32MAX = 0xFFFFFFFFull;

static inline u64 gl_add(u64 a, u64 b) {
    u128 s = (u128)a + b;
    if (s >= P) s -= P;
    return (u64)s;
}
static inline u64 gl_sub(u64 a, u64 b) { return a >= b ? a - b : a + P - b; }
static inline u64 gl_mul(u64 a, u64 b) {
    u128 prod = (u128)a * b;
    u64 lo = (u64)prod;
    u64 hi = (u64)(prod >> 64);
    u64 hi_lo = hi & U32MAX;
    u64 hi_hi = hi >> 32;
    u64 t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= U32MAX;  // wrap-corrected borrow (mod p trick)
    u64 t1 = hi_lo * U32MAX;
    u64 res = t0 + t1;
    if (res < t1 || res >= P) res -= P;
    return res;
}
static inline u64 gl_inv(u64 a) {
    // a^(p-2) by square-and-multiply
    u64 result = 1, base = a, e = P - 2;
    while (e) {
        if (e & 1) result = gl_mul(result, base);
        base = gl_mul(base, base);
        e >>= 1;
    }
    return result;
}

// ---- instruction table --------------------------------------------------

enum Op {
    OP_ADD = 0, OP_MUL, OP_EQ, OP_NEQ, OP_ASSERT, OP_MOV, OP_NOT, OP_JMP,
    OP_CJMP, OP_CALL, OP_RET, OP_MLOAD, OP_MSTORE, OP_RANGE, OP_AND, OP_OR,
    OP_XOR, OP_GTE, OP_TLOAD, OP_TSTORE, OP_END,
};

// opcode-mask bit positions (core/src/vm/opcodes.rs)
struct OpMaskEntry { int op; u64 mask; };

struct Instr {
    int op;          // Op enum
    int dst;         // dst reg or -1
    int op0;         // op0 reg or -1
    int op1_reg;     // op1 reg, -1 if imm / unused, 255 = psp sentinel
    u64 imm;         // imm value (op1 or offset or factor)
    int use_imm;     // 1 if op1/offset is immediate
    u64 factor;      // mload/mstore factor form (use_imm = 0 with factor)
    int has_factor;  // 1 for [r, r, factor] addressing
    u64 step;        // pc advance
    u64 instr_word;  // encoded instruction (for the trace)
    u64 imm_word;    // encoded immediate extension word
    int op1_imm_flag;// decode-level imm flag (Step.op1_imm)
    u64 opcode_mask; // 1 << shift
    int pause;       // pause AFTER executing this pc (prophet attached)
};

// ---- journals -----------------------------------------------------------

struct MemCell {
    u64 clk;
    u64 op;
    uint8_t is_rw, is_write, filter, region_p, region_h;
    u64 value;
};

struct TapeCell {
    u64 clk, op, value;
    uint8_t is_init, filter;
};

// cpu row fields (see runtime/fast_executor.py for the consuming side)
enum {
    CF_CLK = 0, CF_PC, CF_TP, CF_INSTR, CF_IMM, CF_OPCODE, CF_OP1IMM,
    CF_REG0,  // ..CF_REG0+9
    CF_OP0 = CF_REG0 + 10, CF_OP1, CF_DST, CF_AUX0, CF_AUX1,
    CF_SEL_OP0, CF_SEL_OP1, CF_SEL_DST,  // one-hot index + 1 (0 = none)
    CF_IS_EXT, CF_EXT_CNT, CF_FILTER_TAPE, CF_SEL_OP0_VAL0,
    CPU_FIELDS,
};

struct Session {
    std::vector<Instr> code;        // indexed by pc
    std::vector<uint8_t> valid_pc;
    u64 regs[10];
    u64 pc, clk, tp;
    u64 psp_start;
    std::map<u64, std::vector<MemCell>> mem;
    std::unordered_map<u64, u64> mem_last;  // addr -> last value
    std::map<u64, std::vector<TapeCell>> tape;
    std::unordered_map<u64, u64> tape_last;
    std::unordered_map<u64, uint8_t> tape_init;
    std::vector<u64> cpu_rows;      // flat (n, CPU_FIELDS)
    std::vector<u64> rc_rows;       // flat (n, 2): value, filter code
    std::vector<u64> bw_rows;       // flat (n, 4)
    std::vector<u64> cmp_rows;      // flat (n, 4)
    std::vector<u64> ret_vals;
    std::vector<u64> mem_table;     // flat (n, 16) final memory rows
    u64 err_addr;
    int status;                     // 0 ok/end, 1 paused, <0 error
    int pending_tick;               // clk++ owed after a prophet pause
};

static void mem_record(Session* s, u64 addr, u64 clk, u64 op, int is_rw,
                       int is_write, int filter, int rp, int rh, u64 value) {
    s->mem[addr].push_back(MemCell{clk, op, (uint8_t)is_rw, (uint8_t)is_write,
                                   (uint8_t)filter, (uint8_t)rp, (uint8_t)rh,
                                   value});
    s->mem_last[addr] = value;
}

static inline void region_of(u64 addr, int* is_rw, int* rp, int* rh) {
    if (addr >= PSP_START) { *is_rw = 0; *rp = 1; *rh = 0; }
    else if (addr >= HP_START) { *is_rw = 1; *rp = 0; *rh = 1; }
    else { *is_rw = 1; *rp = 0; *rh = 0; }
}

static int mem_read(Session* s, u64 addr, u64 clk, u64 op, int filter,
                    u64* out) {
    auto it = s->mem_last.find(addr);
    if (it == s->mem_last.end()) { s->err_addr = addr; return -2; }
    int is_rw, rp, rh;
    region_of(addr, &is_rw, &rp, &rh);
    u64 v = it->second;
    s->mem[addr].push_back(MemCell{clk, op, (uint8_t)is_rw, 0,
                                   (uint8_t)filter, (uint8_t)rp, (uint8_t)rh,
                                   v});
    *out = v;
    return 0;
}

static int mem_write(Session* s, u64 addr, u64 clk, u64 op, int filter,
                     u64 value, int allow_prophet) {
    if (addr >= PSP_START && !allow_prophet) { s->err_addr = addr; return -3; }
    int is_rw, rp, rh;
    region_of(addr, &is_rw, &rp, &rh);
    s->mem[addr].push_back(MemCell{clk, op, (uint8_t)is_rw, 1,
                                   (uint8_t)filter, (uint8_t)rp, (uint8_t)rh,
                                   value});
    s->mem_last[addr] = value;
    return 0;
}

static int tape_read(Session* s, u64 addr, u64 clk, u64 op, int filter,
                     u64* out) {
    auto it = s->tape_last.find(addr);
    if (it == s->tape_last.end()) { s->err_addr = addr; return -4; }
    u64 v = it->second;
    uint8_t init = s->tape_init[addr];
    s->tape[addr].push_back(TapeCell{clk, op, v, init, (uint8_t)filter});
    *out = v;
    return 0;
}

static void tape_write(Session* s, u64 addr, u64 clk, u64 op, int is_init,
                       int filter, u64 value) {
    s->tape[addr].push_back(
        TapeCell{clk, op, value, (uint8_t)is_init, (uint8_t)filter});
    s->tape_last[addr] = value;
    if (s->tape.find(addr)->second.size() == 1) s->tape_init[addr] = is_init;
}

// ---- cpu row emission ----------------------------------------------------

struct RowCtx {
    u64 fields[CPU_FIELDS];
};

static void row_begin(Session* s, RowCtx* r, const Instr& in, u64 pc_status,
                      u64 tp_status) {
    memset(r->fields, 0, sizeof(r->fields));
    r->fields[CF_CLK] = s->clk;
    r->fields[CF_PC] = pc_status;
    r->fields[CF_TP] = tp_status;
    r->fields[CF_INSTR] = in.instr_word;
    r->fields[CF_IMM] = in.imm_word;
    r->fields[CF_OPCODE] = in.opcode_mask;
    r->fields[CF_OP1IMM] = (u64)in.op1_imm_flag;
    for (int i = 0; i < 10; i++) r->fields[CF_REG0 + i] = s->regs[i];
}

static void row_emit(Session* s, const RowCtx* r) {
    s->cpu_rows.insert(s->cpu_rows.end(), r->fields, r->fields + CPU_FIELDS);
}

// resolve op1 operand: returns value; sel_reg = reg index or -1
static u64 operand(Session* s, const Instr& in, int* sel_reg) {
    if (in.use_imm) { *sel_reg = -1; return in.imm; }
    if (in.op1_reg == 255) { *sel_reg = -1; return s->psp_start; }
    *sel_reg = in.op1_reg;
    return s->regs[in.op1_reg];
}

extern "C" {

Session* exe_create() { return new Session(); }
void exe_destroy(Session* s) { delete s; }

void exe_load_code(Session* s, const u64* table, u64 n_rows, u64 code_len) {
    // table rows: op, dst, op0, op1_reg, imm, use_imm, factor, has_factor,
    //             step, instr_word, imm_word, op1_imm_flag, opcode_mask,
    //             pause, pc   (15 columns)
    s->code.assign(code_len, Instr{});
    s->valid_pc.assign(code_len, 0);
    for (u64 i = 0; i < n_rows; i++) {
        const u64* r = table + i * 15;
        u64 pc = r[14];
        Instr& in = s->code[pc];
        in.op = (int)r[0];
        in.dst = (int)(i64)r[1];
        in.op0 = (int)(i64)r[2];
        in.op1_reg = (int)(i64)r[3];
        in.imm = r[4];
        in.use_imm = (int)r[5];
        in.factor = r[6];
        in.has_factor = (int)r[7];
        in.step = r[8];
        in.instr_word = r[9];
        in.imm_word = r[10];
        in.op1_imm_flag = (int)r[11];
        in.opcode_mask = r[12];
        in.pause = (int)r[13];
        s->valid_pc[pc] = 1;
    }
    // heap-pointer init cell (process.py execute: write with rh = 1)
    mem_record(s, HP_START, 0, 0, 1, 1, 0, 0, 1, HP_START + 1);
}

void exe_init_tape(Session* s, const u64* addrs, const u64* values,
                   const u64* is_init, const u64* clks, const u64* ops,
                   const u64* filters, u64 n, u64 tp) {
    for (u64 i = 0; i < n; i++) {
        tape_write(s, addrs[i], clks[i], ops[i], (int)is_init[i],
                   (int)filters[i], values[i]);
    }
    s->tp = tp;
}

void exe_set_state(Session* s, const u64* regs, u64 pc, u64 clk, u64 tp,
                   u64 psp_start) {
    for (int i = 0; i < 10; i++) s->regs[i] = regs[i];
    s->pc = pc;
    s->clk = clk;
    s->tp = tp;
    s->psp_start = psp_start;
}

void exe_get_state(Session* s, u64* regs, u64* out4) {
    for (int i = 0; i < 10; i++) regs[i] = s->regs[i];
    out4[0] = s->pc;
    out4[1] = s->clk;
    out4[2] = s->tp;
    out4[3] = s->err_addr;
}

// prophet-side memory access: explicit region flags (process.py
// _read_prophet_input hardcodes is_rw=RW, rp=rh=0 regardless of address)
int exe_mem_read_raw(Session* s, u64 addr, u64 clk, u64 op, u64 is_rw,
                     u64 filter, u64 rp, u64 rh, u64* out) {
    auto it = s->mem_last.find(addr);
    if (it == s->mem_last.end()) { s->err_addr = addr; return -2; }
    u64 v = it->second;
    s->mem[addr].push_back(MemCell{clk, op, (uint8_t)is_rw, 0,
                                   (uint8_t)filter, (uint8_t)rp, (uint8_t)rh,
                                   v});
    *out = v;
    return 0;
}
u64 exe_mem_peek(Session* s, u64 addr, int* ok) {
    auto it = s->mem_last.find(addr);
    if (it == s->mem_last.end()) { *ok = 0; return 0; }
    *ok = 1;
    return it->second;
}
void exe_mem_write_once(Session* s, u64 addr, u64 value) {
    // prophet psp write: region (WriteOnce, 1, 0), clk 0, op 0, filter 0
    s->mem[addr].push_back(MemCell{0, 0, 0, 1, 0, 1, 0, value});
    s->mem_last[addr] = value;
}

// run until END (returns 0), a pause pc (returns 1), or error (<0)
int exe_run(Session* s, u64 max_steps) {
    u64 executed = 0;
    const u64 n_code = s->code.size();
    while (executed++ < max_steps) {
        if (s->pending_tick) { s->clk += 1; s->pending_tick = 0; }
        if (s->pc >= n_code || !s->valid_pc[s->pc]) { s->err_addr = s->pc; return -1; }
        const Instr& in = s->code[s->pc];
        const u64 pc_status = s->pc;
        const u64 tp_status = s->tp;
        RowCtx r;
        row_begin(s, &r, in, pc_status, tp_status);
        int rc;
        u64 v;
        int sel;

        switch (in.op) {
        case OP_MOV: case OP_NOT: {
            u64 val = operand(s, in, &sel);
            r.fields[CF_OP1] = val;
            if (sel >= 0) r.fields[CF_SEL_OP1] = sel + 1;
            s->regs[in.dst] = (in.op == OP_MOV) ? val : gl_sub(P - 1, val);
            r.fields[CF_DST] = s->regs[in.dst];
            r.fields[CF_SEL_DST] = in.dst + 1;
            s->pc += in.step;
            break;
        }
        case OP_EQ: case OP_NEQ: {
            u64 val = operand(s, in, &sel);
            r.fields[CF_OP0] = s->regs[in.op0];
            r.fields[CF_SEL_OP0] = in.op0 + 1;
            r.fields[CF_OP1] = val;
            if (sel >= 0) r.fields[CF_SEL_OP1] = sel + 1;
            u64 diff = gl_sub(s->regs[in.op0], val);
            r.fields[CF_AUX0] = diff ? gl_inv(diff) : 0;
            u64 res = (s->regs[in.op0] == val) ? 1 : 0;
            if (in.op == OP_NEQ) res = 1 - res;
            s->regs[in.dst] = res;
            r.fields[CF_DST] = res;
            r.fields[CF_SEL_DST] = in.dst + 1;
            s->pc += in.step;
            break;
        }
        case OP_ASSERT: {
            u64 val = operand(s, in, &sel);
            r.fields[CF_OP1] = val;
            if (sel >= 0) r.fields[CF_SEL_OP1] = sel + 1;
            if (val != 1) { s->err_addr = pc_status; return -5; }
            s->pc += in.step;
            break;
        }
        case OP_CJMP: {
            u64 val = operand(s, in, &sel);
            r.fields[CF_OP0] = s->regs[in.op0];
            r.fields[CF_SEL_OP0] = in.op0 + 1;
            r.fields[CF_OP1] = val;
            if (sel >= 0) r.fields[CF_SEL_OP1] = sel + 1;
            if (s->regs[in.op0] == 1) s->pc = val; else s->pc += in.step;
            break;
        }
        case OP_JMP: {
            u64 val = operand(s, in, &sel);
            r.fields[CF_OP1] = val;
            if (sel >= 0) r.fields[CF_SEL_OP1] = sel + 1;
            s->pc = val;
            break;
        }
        case OP_ADD: case OP_MUL: {
            u64 val = operand(s, in, &sel);
            r.fields[CF_OP0] = s->regs[in.op0];
            r.fields[CF_SEL_OP0] = in.op0 + 1;
            r.fields[CF_OP1] = val;
            if (sel >= 0) r.fields[CF_SEL_OP1] = sel + 1;
            s->regs[in.dst] = (in.op == OP_ADD) ? gl_add(s->regs[in.op0], val)
                                                : gl_mul(s->regs[in.op0], val);
            r.fields[CF_DST] = s->regs[in.dst];
            r.fields[CF_SEL_DST] = in.dst + 1;
            s->pc += in.step;
            break;
        }
        case OP_CALL: {
            u64 val = operand(s, in, &sel);
            u64 fp = s->regs[9];
            u64 next_pc = s->pc + in.step;
            rc = mem_write(s, gl_sub(fp, 1), s->clk, in.opcode_mask, 1,
                           next_pc, 0);
            if (rc) return rc;
            r.fields[CF_OP0] = gl_sub(fp, 1);
            r.fields[CF_DST] = next_pc;
            r.fields[CF_OP1] = val;
            if (sel >= 0) r.fields[CF_SEL_OP1] = sel + 1;
            r.fields[CF_AUX0] = gl_sub(fp, 2);
            rc = mem_read(s, gl_sub(fp, 2), s->clk, in.opcode_mask, 1, &v);
            if (rc) return rc;
            r.fields[CF_AUX1] = v;
            s->pc = val;
            break;
        }
        case OP_RET: {
            u64 fp = s->regs[9];
            r.fields[CF_OP0] = gl_sub(fp, 1);
            r.fields[CF_AUX0] = gl_sub(fp, 2);
            rc = mem_read(s, gl_sub(fp, 1), s->clk, in.opcode_mask, 1, &v);
            if (rc) return rc;
            s->pc = v;
            rc = mem_read(s, gl_sub(fp, 2), s->clk, in.opcode_mask, 1, &v);
            if (rc) return rc;
            s->regs[9] = v;
            r.fields[CF_DST] = s->pc;
            r.fields[CF_AUX1] = v;
            break;
        }
        case OP_MSTORE: {
            // forms: mstore rX off rD | mstore rX rY factor rD
            u64 op0_val = s->regs[in.op0];
            r.fields[CF_OP0] = op0_val;
            r.fields[CF_SEL_OP0] = in.op0 + 1;
            u64 offset;
            if (!in.has_factor) {
                offset = in.imm;
                r.fields[CF_OP1IMM] = 1;
                r.fields[CF_OP1] = offset;
                r.fields[CF_AUX0] = 0;
            } else {
                r.fields[CF_OP1] = s->regs[in.op1_reg];
                r.fields[CF_SEL_OP1] = in.op1_reg + 1;
                r.fields[CF_AUX0] = in.factor;
                offset = gl_mul(in.factor, s->regs[in.op1_reg]);
                r.fields[CF_OP1IMM] = 0;
            }
            r.fields[CF_DST] = s->regs[in.dst];
            r.fields[CF_SEL_DST] = in.dst + 1;
            u64 addr = gl_add(op0_val, offset);
            r.fields[CF_AUX1] = addr;
            rc = mem_write(s, addr, s->clk, in.opcode_mask, 1,
                           s->regs[in.dst], 0);
            if (rc) return rc;
            s->pc += in.step;
            break;
        }
        case OP_MLOAD: {
            u64 op0_val = s->regs[in.op0];
            r.fields[CF_OP0] = op0_val;
            r.fields[CF_SEL_OP0] = in.op0 + 1;
            u64 offset;
            if (!in.has_factor) {
                offset = in.imm;
                r.fields[CF_OP1IMM] = 1;
                r.fields[CF_OP1] = offset;
                r.fields[CF_AUX0] = 0;
            } else {
                r.fields[CF_OP1] = s->regs[in.op1_reg];
                r.fields[CF_SEL_OP1] = in.op1_reg + 1;
                r.fields[CF_AUX0] = in.factor;
                offset = gl_mul(in.factor, s->regs[in.op1_reg]);
                r.fields[CF_OP1IMM] = 0;
            }
            u64 addr = gl_add(op0_val, offset);
            r.fields[CF_AUX1] = addr;
            rc = mem_read(s, addr, s->clk, in.opcode_mask, 1, &v);
            if (rc) return rc;
            s->regs[in.dst] = v;
            r.fields[CF_DST] = v;
            r.fields[CF_SEL_DST] = in.dst + 1;
            s->pc += in.step;
            break;
        }
        case OP_RANGE: {
            // op1 is a register (ops[1])
            u64 val = s->regs[in.op1_reg];
            if (val > U32MAX) { s->err_addr = pc_status; return -6; }
            r.fields[CF_OP1] = val;
            r.fields[CF_SEL_OP1] = in.op1_reg + 1;
            s->rc_rows.push_back(val);
            s->rc_rows.push_back(1);  // cpu filter
            s->pc += in.step;
            break;
        }
        case OP_AND: case OP_OR: case OP_XOR: {
            u64 val = operand(s, in, &sel);
            u64 a = s->regs[in.op0];
            r.fields[CF_OP0] = a;
            r.fields[CF_SEL_OP0] = in.op0 + 1;
            r.fields[CF_OP1] = val;
            if (sel >= 0) r.fields[CF_SEL_OP1] = sel + 1;
            u64 res = (in.op == OP_AND) ? (a & val)
                      : (in.op == OP_OR) ? (a | val) : (a ^ val);
            s->regs[in.dst] = res;
            r.fields[CF_DST] = res;
            r.fields[CF_SEL_DST] = in.dst + 1;
            s->bw_rows.push_back(in.opcode_mask);
            s->bw_rows.push_back(a);
            s->bw_rows.push_back(val);
            s->bw_rows.push_back(res);
            s->pc += in.step;
            break;
        }
        case OP_GTE: {
            u64 val = operand(s, in, &sel);
            u64 a = s->regs[in.op0];
            r.fields[CF_OP0] = a;
            r.fields[CF_SEL_OP0] = in.op0 + 1;
            r.fields[CF_OP1] = val;
            if (sel >= 0) r.fields[CF_SEL_OP1] = sel + 1;
            u64 res = a >= val ? 1 : 0;
            s->regs[in.dst] = res;
            r.fields[CF_DST] = res;
            r.fields[CF_SEL_DST] = in.dst + 1;
            u64 abs_diff = res ? gl_sub(a, val) : gl_sub(val, a);
            if (abs_diff > U32MAX) { s->err_addr = pc_status; return -6; }
            s->rc_rows.push_back(abs_diff);
            s->rc_rows.push_back(2);  // cmp filter
            s->cmp_rows.push_back(a);
            s->cmp_rows.push_back(val);
            s->cmp_rows.push_back(res);
            s->cmp_rows.push_back(abs_diff);
            s->pc += in.step;
            break;
        }
        case OP_TLOAD: {
            u64 op1_val = operand(s, in, &sel);
            u64 mem_base = s->regs[in.dst];
            r.fields[CF_DST] = mem_base;
            r.fields[CF_AUX1] = s->regs[in.op0];
            r.fields[CF_OP1] = op1_val;
            r.fields[CF_SEL_DST] = in.dst + 1;
            r.fields[CF_SEL_OP0] = in.op0 + 1;
            if (sel >= 0) r.fields[CF_SEL_OP1] = sel + 1;
            u64 flag = s->regs[in.op0];
            u64 tape_base, zone_len;
            if (flag == 1) {
                tape_base = gl_sub(s->tp, op1_val);
                zone_len = op1_val;
                r.fields[CF_OP0] = 1;
            } else if (flag == 0) {
                tape_base = op1_val;
                zone_len = 1;
                r.fields[CF_OP0] = 0;
            } else { s->err_addr = pc_status; return -7; }
            s->pc += in.step;
            row_emit(s, &r);  // main line first
            // ext lines
            RowCtx e = r;
            e.fields[CF_IS_EXT] = 1;
            e.fields[CF_FILTER_TAPE] = 1;
            for (u64 i = 0; i < zone_len; i++) {
                u64 ta = tape_base + i;
                u64 ma = mem_base + i;
                rc = tape_read(s, ta, s->clk, in.opcode_mask, 1, &v);
                if (rc) return rc;
                rc = mem_write(s, ma, s->clk, in.opcode_mask, 1, v, 0);
                if (rc) return rc;
                e.fields[CF_AUX0] = ma;
                e.fields[CF_AUX1] = v;
                e.fields[CF_SEL_OP0_VAL0] = ta;
                e.fields[CF_EXT_CNT] = i + 1;
                row_emit(s, &e);
            }
            goto after_emit;
        }
        case OP_TSTORE: {
            u64 op1_val = operand(s, in, &sel);
            u64 mem_base = s->regs[in.op0];
            r.fields[CF_OP0] = mem_base;
            r.fields[CF_SEL_OP0] = in.op0 + 1;
            r.fields[CF_OP1] = op1_val;
            if (sel >= 0) r.fields[CF_SEL_OP1] = sel + 1;
            u64 tape_base = s->tp;
            s->pc += in.step;
            row_emit(s, &r);
            RowCtx e = r;
            e.fields[CF_IS_EXT] = 1;
            e.fields[CF_FILTER_TAPE] = 1;
            for (u64 i = 0; i < op1_val; i++) {
                u64 ma = mem_base + i;
                u64 ta = tape_base + i;
                if (ma >= PSP_START) { s->err_addr = ma; return -3; }
                rc = mem_read(s, ma, s->clk, in.opcode_mask, 1, &v);
                if (rc) return rc;
                tape_write(s, ta, s->clk, in.opcode_mask, 0, 1, v);
                e.fields[CF_AUX0] = ma;
                e.fields[CF_AUX1] = v;
                e.fields[CF_SEL_OP0_VAL0] = ta;
                e.fields[CF_EXT_CNT] = i + 1;
                row_emit(s, &e);
            }
            s->tp = gl_add(s->tp, op1_val);
            goto after_emit;
        }
        case OP_END: {
            // return data = tape tail (process.py _inst_end; no trace cells)
            if (s->tp > 0) {
                auto it = s->tape_last.find(s->tp - 1);
                if (it == s->tape_last.end()) { s->err_addr = s->tp - 1; return -4; }
                u64 length = it->second;
                for (u64 i = 0; i < length; i++) {
                    auto vi = s->tape_last.find(s->tp - length - 1 + i);
                    if (vi == s->tape_last.end()) { s->err_addr = i; return -4; }
                    s->ret_vals.push_back(vi->second);
                }
            }
            row_emit(s, &r);
            s->status = 0;
            return 0;
        }
        default:
            s->err_addr = pc_status;
            return -1;
        }
        row_emit(s, &r);
    after_emit:
        if (s->pc >= n_code) { s->status = 0; return 0; }
        if (in.pause) { s->status = 1; s->pending_tick = 1; s->err_addr = pc_status; return 1; }
        s->clk += 1;
    }
    s->err_addr = 0;
    return -8;  // step limit
}

// ---- exports: sizes + data ------------------------------------------------

u64 exe_n_cpu(Session* s) { return s->cpu_rows.size() / CPU_FIELDS; }
u64 exe_n_rc(Session* s) { return s->rc_rows.size() / 2; }
u64 exe_n_bw(Session* s) { return s->bw_rows.size() / 4; }
u64 exe_n_cmp(Session* s) { return s->cmp_rows.size() / 4; }
u64 exe_n_ret(Session* s) { return s->ret_vals.size(); }

void exe_export_cpu(Session* s, u64* out) {
    memcpy(out, s->cpu_rows.data(), s->cpu_rows.size() * 8);
}
void exe_export_rc(Session* s, u64* out) {
    memcpy(out, s->rc_rows.data(), s->rc_rows.size() * 8);
}
void exe_export_bw(Session* s, u64* out) {
    memcpy(out, s->bw_rows.data(), s->bw_rows.size() * 8);
}
void exe_export_cmp(Session* s, u64* out) {
    memcpy(out, s->cmp_rows.data(), s->cmp_rows.size() * 8);
}
void exe_export_ret(Session* s, u64* out) {
    memcpy(out, s->ret_vals.data(), s->ret_vals.size() * 8);
}

// memory table finalization (executor/src/trace.rs:20-200 semantics,
// mirroring runtime/finalize.py:gen_memory_table exactly). Returns row
// count (UINT64_MAX on a rangecheck overflow); rows via exe_export_memory.
// Memory-phase rangecheck rows are appended to the shared rc buffer.
u64 exe_finalize_memory(Session* s) {
    // pop the synthetic heap-init cell's first entry
    auto hp_it = s->mem.find(HP_START);
    if (hp_it != s->mem.end() && !hp_it->second.empty()) {
        hp_it->second.erase(hp_it->second.begin());
    }
    s->mem_table.clear();
    u64 origin_addr = 0, origin_clk = 0;
    bool first_row = true, first_heap_row = true;
    for (auto& kv : s->mem) {
        u64 addr = kv.first % P;
        bool new_addr = true;
        for (const MemCell& c : kv.second) {
            u64 diff_addr_cond;
            bool write_once = false;
            if (c.region_p) { diff_addr_cond = P - addr; write_once = true; }
            else if (c.region_h) { diff_addr_cond = P - MEM_SPAN - addr; }
            else diff_addr_cond = 0;
            u64 diff_addr = 0, diff_addr_inv = 0, diff_clk = 0, rc_value = 0;
            u64 rw_unchanged = 0;
            // rc inserts: pairs (value, code) code 0=mem_sort 4=mem_region
            u64 rc_a = UINT64_MAX, rc_a_code = 0, rc_b = UINT64_MAX,
                rc_b_code = 0;
            if (first_row) {
                first_row = false;
                new_addr = false;
                if (c.region_h) first_heap_row = false;
            } else if (new_addr) {
                diff_addr = addr - origin_addr;
                if (write_once) {
                    rc_value = diff_addr_cond;
                    rc_a = diff_addr_cond; rc_a_code = 4;
                } else if (c.region_h && first_heap_row) {
                    diff_addr = 0;
                    rc_value = 0;
                    rc_a = diff_addr_cond; rc_a_code = 4;
                    first_heap_row = false;
                } else {
                    diff_addr_inv = diff_addr ? gl_inv(diff_addr) : 0;
                    rc_value = diff_addr;
                    rc_a = rc_value; rc_a_code = 0;
                    if (c.region_h) { rc_b = diff_addr_cond; rc_b_code = 4; }
                }
                new_addr = false;
            } else {
                diff_clk = c.clk - origin_clk;
                rw_unchanged = 1;
                if (c.is_rw == 0) {
                    rw_unchanged = 0;
                    rc_value = diff_addr_cond;
                    rc_a = rc_value; rc_a_code = 4;
                } else {
                    rc_value = diff_clk;
                    rc_a = rc_value; rc_a_code = 0;
                }
                if (c.region_h) { rc_b = diff_addr_cond; rc_b_code = 4; }
            }
            if ((rc_a != UINT64_MAX && rc_a > U32MAX) ||
                (rc_b != UINT64_MAX && rc_b > U32MAX)) {
                s->err_addr = addr;
                return UINT64_MAX;
            }
            if (rc_a != UINT64_MAX) {
                s->rc_rows.push_back(rc_a);
                s->rc_rows.push_back(rc_a_code);
            }
            if (rc_b != UINT64_MAX) {
                s->rc_rows.push_back(rc_b);
                s->rc_rows.push_back(rc_b_code);
            }
            u64 row[16] = {0, addr, c.clk, (u64)c.is_rw, c.op,
                           (u64)c.is_write, diff_addr, diff_addr_inv,
                           diff_clk, diff_addr_cond, (u64)c.filter,
                           rw_unchanged, (u64)c.region_p, (u64)c.region_h,
                           c.value, rc_value};
            s->mem_table.insert(s->mem_table.end(), row, row + 16);
            origin_clk = c.clk;
        }
        origin_addr = addr;
    }
    return s->mem_table.size() / 16;
}

void exe_export_memory(Session* s, u64* out) {
    memcpy(out, s->mem_table.data(), s->mem_table.size() * 8);
}

// tape rows sorted by addr, per-addr visit order: (is_init, op, addr, value,
// filter) x n
u64 exe_n_tape(Session* s) {
    u64 n = 0;
    for (auto& kv : s->tape) n += kv.second.size();
    return n;
}
void exe_export_tape(Session* s, u64* out) {
    u64 i = 0;
    for (auto& kv : s->tape) {
        for (const TapeCell& c : kv.second) {
            out[i * 5 + 0] = c.is_init;
            out[i * 5 + 1] = c.op;
            out[i * 5 + 2] = kv.first;
            out[i * 5 + 3] = c.value;
            out[i * 5 + 4] = c.filter;
            i++;
        }
    }
}

}  // extern "C"
